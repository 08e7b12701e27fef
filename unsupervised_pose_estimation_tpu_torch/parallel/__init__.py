"""The device mesh over processes (``mesh``) and its multi-process dry run
(``dryrun``)."""
