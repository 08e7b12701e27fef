"""Readings that the correctness limits are set from, for one cell, in one
process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] [--look-seeds 1 2] \
        [--seconds 3]

- the program: each compared number of the cell's check, one line per
  seed (training cells run no window: their numbers come from the first
  steps; serving cells run a short window at the cell's load);
- the control: the plain reference in the precision below the
  configuration's (bfloat16 -> fp8, float32 -> TF32) put in the program's
  place, or in ``--precision`` (``bfloat16``: a witness of what the
  configuration's own precision reads);
- planted faults, for training cells: the reference trained on half of
  each batch, the mean taken over it;
- the look, for training cells (``--look-seeds``): for the worst leaf of
  the change and of the first gradient, how many of its elements' first
  gradients differ in sign between program and reference (Adam's first
  step is lr x sign), how small those gradients are, and how much of the
  leaf's gap the flipped elements alone account for.

Each reading is one JSON line on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def look(keep: dict, leaf: str) -> dict:
    """One leaf's first gradients and changes, element by element."""
    import torch

    def flat(side, name=leaf):
        return keep[side][name].float().flatten()

    def norm(t):
        return float(torch.linalg.vector_norm(t))

    gp, gr = flat("grads"), flat("ref_grads")
    cp, cr = flat("changes"), flat("ref_changes")
    lr = keep["lr"]
    cmed = float(torch.stack([torch.linalg.vector_norm(t.float()) for t in
                              keep["ref_changes"].values()]).median())
    scale = max(norm(cr), cmed)
    flip = torch.sign(gp) != torch.sign(gr)
    diff = cp - cr
    rec = {"elements": gr.numel(), "flipped": int(flip.sum()),
           "lr": lr, "ref_change_norm": norm(cr), "prog_change_norm": norm(cp),
           "median_leaf_change_norm": cmed,
           "gap": abs(norm(cp) - norm(cr)) / scale,
           # the gap if the flipped elements alone moved as the program's
           "gap_flips_only": abs(norm(torch.where(flip, cp, cr)) - norm(cr))
           / scale,
           "diff_share_flipped": norm(diff[flip]) ** 2 / max(
               norm(diff) ** 2, 1e-30)}
    if rec["flipped"]:
        med = float(gr.abs().median())
        rec.update(
            flipped_ref_grad_over_median=float(gr[flip].abs().median())
            / max(med, 1e-30),
            flipped_grad_rel_err=float(((gp - gr)[flip].abs()
                                        / gr[flip].abs()).median()),
            flipped_change_diff_over_lr=float(diff[flip].abs().mean()) / lr,
            other_change_diff_over_lr=(float(diff[~flip].abs().mean()) / lr
                                       if (~flip).any() else None))
    return rec


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--look-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--precision", default=None)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    cfg_file = harness.config(cell["config"])
    mix = harness.mix(cell["traffic"])
    traffic = harness.traffic_module(mix["kind"])
    device = torch.device("cuda", 0)
    control = (args.precision or
               harness.CONTROL[cfg_file["options"]["compute_dtype"]])
    training = mix["kind"] == "train_loop"

    def emit(what, seed, readings, **extra):
        rec = dict(cell=args.workload, what=what, seed=seed,
                   readings=readings, device=torch.cuda.get_device_name(
                       device), **extra)
        print(json.dumps(rec), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        out = traffic.run(cfg_file, mix, seed,
                          0.0 if training else args.seconds, False, device,
                          harness.Spans(), t0)
        emit("program", seed, out["readings"],
             seconds=time.perf_counter() - t0)
    for seed in args.control_seeds:
        emit("control_" + control, seed,
             traffic.control(cfg_file, mix, seed, device, control))
    for seed in args.look_seeds if training else []:
        keep = {}
        out = traffic.run(cfg_file, mix, seed, 0.0, False, device,
                          harness.Spans(), time.perf_counter(), keep=keep)
        readings = out["readings"]
        emit("look", seed, {k: readings[k] for k in (
            "grad_gap", "update_gap", "grad_worst", "update_worst")},
             update_leaf=look(keep, readings["update_worst"]),
             grad_leaf=look(keep, readings["grad_worst"]))
    if training:
        half = cfg_file["options"]["batch_size"] // 2
        for seed in args.fault_seeds:
            emit("fault_half_batch", seed,
                 traffic.control(cfg_file, mix, seed, device, "float32",
                                 rows=slice(0, half)))


if __name__ == "__main__":
    main()
