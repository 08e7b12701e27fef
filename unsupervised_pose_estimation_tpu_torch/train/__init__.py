"""Model container and the validation / inference steps of the port."""
