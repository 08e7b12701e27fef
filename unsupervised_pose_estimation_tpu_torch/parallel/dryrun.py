"""Dry run of the mesh: local processes train on one global batch, and
each step is held to the one-process step from the same state.

    python -m unsupervised_pose_estimation_tpu_torch.parallel.dryrun --procs 2 --device cpu

The counterpart of the reference's ``__graft_entry__.py --multihost 2``.
``launch`` starts ``procs`` copies of this module as the ranks of a process
group on 127.0.0.1 and hands them a list of cases. The device sets the
backend: "cuda" (a card per rank, ``cuda:LOCAL_RANK``) runs NCCL; the CPU,
or one card that every rank shares ("cuda:0"), runs gloo. A case is a mesh (the ``mesh_*`` options) and a few training
steps of ``train.step.build_train_step`` over it on global batches of
``synthetic_parallax`` items, or given ones (``batch`` names a file of
{"batches": [...], "noise": [{scale: tensor} or None, ...]}). For the
first ``compare`` steps rank 0 first copies the mesh's state (the
gathered parameters, BatchNorm statistics and Adam moments, and the step)
into a one-process bundle and takes that bundle's step on the whole
global batch, with the same noise; at ``compute_dtype="bfloat16"`` also a
float32 one, whose gap sizes the bfloat16 bounds. Every rank writes
``rank<r>.json``: per step the losses, a digest of its parameters and
statistics, wall ms, collectives and kernel launches; rank 0 adds the
comparisons. ``check`` holds the results to their bounds. A case can also
save a checkpoint after a step and resume from it (the resumed steps must
repeat the uninterrupted ones bit for bit; ``ckpt`` in the results names
the file and the digest of the state it holds), or restore a checkpoint
first (its digest must equal the file's).

The workers end themselves when their parent dies, and ``launch`` kills
them at its timeout.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

MODULE = "unsupervised_pose_estimation_tpu_torch.parallel.dryrun"
_ROOT = Path(__file__).resolve().parents[2]
_OPT_KEYS = ("exp_avg", "exp_avg_sq")

# float32 bounds of a step over the mesh against the one-process step from
# the same state: losses at rtol LOSS_RTOL; grad_norm at NORM_RTOL (an input
# within rounding of a kink of the loss can take the other branch when sums
# run in another order); parameters within PARAM_LR learning rates plus
# PARAM_ATOL (Adam's first updates are about lr * sign(g), so a gradient at
# the level of rounding can move an element 2 lr), and at most BEYOND_SHARE
# of the elements more than 0.1 lr apart (what a bound of 2 lr cannot see:
# a gradient of the right norm but the wrong direction moves most of them);
# BatchNorm statistics at STATS_ATOL; the fsdp bytes a rank holds at most
# FSDP_SHARE of the whole.
LOSS_RTOL, NORM_RTOL, PARAM_LR, PARAM_ATOL = 1e-5, 1e-2, 2.0, 1e-6
BEYOND_SHARE, STATS_ATOL, FSDP_SHARE = 0.04, 2e-5, 0.65


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_of(device: str) -> str:
    """NCCL for a card per rank ("cuda"), gloo for the CPU or for one card
    that every rank shares ("cuda:0"; NCCL refuses two ranks on one
    device)."""
    d = torch.device(device)
    return "nccl" if d.type == "cuda" and d.index is None else "gloo"


def launch(cases: List[dict], procs: int = 2, device: str = "cuda",
           out_dir: Optional[str] = None, timeout: float = 600.0,
           threads: int = 1) -> List[dict]:
    """Run ``cases`` on ``procs`` local ranks; -> each rank's results, in
    rank order. ``device``: "cuda" (``cuda:LOCAL_RANK``, NCCL), one CUDA
    device that every rank shares ("cuda:0", gloo) or "cpu" (gloo). Raises
    with the ranks' logs when one fails or the run outlasts ``timeout``
    seconds (the ranks are killed)."""
    out = Path(out_dir or tempfile.mkdtemp(prefix="dryrun_"))
    out.mkdir(parents=True, exist_ok=True)
    (out / "cases.json").write_text(json.dumps(cases))
    if torch.device(device).type == "cuda":
        from ..ops.kernels import _lib

        _lib.build()  # once, before the ranks load it
    port = free_port()
    env = {**os.environ, "WORLD_SIZE": str(procs),
           "LOCAL_WORLD_SIZE": str(procs), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port),
           "PYTHONPATH": os.pathsep.join(
               [str(_ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p])}
    ranks = []
    for r in range(procs):
        log = open(out / f"rank{r}.log", "w")
        ranks.append((subprocess.Popen(
            [sys.executable, "-m", MODULE, "--worker", str(out), "--device",
             device, "--threads", str(threads),
             "--timeout", str(timeout)],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=log,
            stderr=subprocess.STDOUT, cwd=str(_ROOT)), log))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p, _ in ranks):
            if time.monotonic() > deadline:
                failed = "timed out"
            for r, (p, _) in enumerate(ranks):
                if p.poll() not in (None, 0):
                    failed = f"rank {r} exited with {p.returncode}"
            time.sleep(0.05)
        for r, (p, _) in enumerate(ranks):
            if failed is None and p.returncode != 0:
                failed = f"rank {r} exited with {p.returncode}"
    finally:
        for p, log in ranks:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed is not None:
        logs = "\n".join(f"--- rank {r} ---\n"
                         + (out / f"rank{r}.log").read_text()[-4000:]
                         for r in range(procs))
        raise RuntimeError(f"dry run {failed}:\n{logs}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(procs)]


def check(results: List[dict], case: str) -> List[str]:
    """The float32 bounds (module constants) on case ``case`` of
    ``launch``'s results; -> the failures (empty: all hold). Every rank
    must end every step with the same parameters and statistics; a
    resumed step must repeat the uninterrupted one, a restored state the
    file's; under fsdp each rank holds at most FSDP_SHARE of the bytes of
    the parameters and of each Adam moment."""
    ranks = [r[case] for r in results]
    head = ranks[0]
    failed = []
    for k, s in enumerate(head["steps"]):
        digests = {r["steps"][k]["digest"] for r in ranks}
        if len(digests) != 1:
            failed.append(f"step {k}: the ranks' parameters differ")
        cmp = s.get("compare")
        if not cmp or head.get("bf16"):
            continue  # bfloat16: the caller's bounds (the f32 gap)
        for name, want in cmp["ref_losses"].items():
            rtol = NORM_RTOL if name == "grad_norm" else LOSS_RTOL
            if not abs(s["losses"][name] - want) <= rtol * abs(want):
                failed.append(f"step {k} {name}: {s['losses'][name]!r} "
                              f"against {want!r}")
        if not cmp["param_max"] <= PARAM_LR * head["lr"] + PARAM_ATOL:
            failed.append(f"step {k}: parameters {cmp['param_max']:.3e} "
                          f"apart")
        if not cmp["param_beyond_0.1lr"] <= BEYOND_SHARE:
            failed.append(f"step {k}: {cmp['param_beyond_0.1lr']:.3%} of "
                          f"the parameters more than 0.1 lr apart")
        if not cmp["stats_max"] <= STATS_ATOL:
            failed.append(f"step {k}: statistics {cmp['stats_max']:.3e} "
                          f"apart")
    for key in ("resumed", "restored"):
        if key in head and not all(r[key]["equal"] for r in ranks):
            failed.append(f"{key}: not bit-equal")
    if head["mesh"][2] > 1:
        for r, res in enumerate(ranks):
            b = res["bytes"]
            for key in ("parameters", *_OPT_KEYS):
                if not b[key] <= FSDP_SHARE * b["total"]:
                    failed.append(f"rank {r} holds {b[key]} of {b['total']} "
                                  f"bytes of {key}")
    return failed


# ---------------------------------------------------------------------------
# helpers of the ranks
# ---------------------------------------------------------------------------


def digest(tensors: Dict[str, torch.Tensor]) -> str:
    """sha256 of named tensors: names, dtypes, shapes and bytes."""
    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        h.update(f"{name} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def state_digest(bundle_sd: dict, optimizer_sd: dict, step: int) -> str:
    """The digest of a checkpoint's contents: the bundle's tensors, the
    Adam moments and steps, the parameter group and the step."""
    tensors = dict(bundle_sd)
    for i, st in optimizer_sd["state"].items():
        for key, t in st.items():
            tensors[f"opt.{i}.{key}"] = t
    groups = json.dumps(optimizer_sd["param_groups"], sort_keys=True,
                        default=str)
    return digest(tensors) + hashlib.sha256(
        f"{groups} {step}".encode()).hexdigest()


def _copy(tree):
    """A copy of the tensors of ``tree``, on their devices."""
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree


def snapshot(bundle, state, moments: bool = True):
    """(a copy of the bundle's state_dict, of the main Adam's in the
    checkpoints' format or None without ``moments``, the step); a
    collective under fsdp."""
    from ..train.state import full_params, optimizer_state_dict

    with full_params(state):
        sd = _copy(bundle.state_dict())
        osd = _copy(optimizer_state_dict(state)) if moments else None
    return sd, osd, state.step


def make_batches(cfg, steps: int, device) -> List[dict]:
    """``steps`` global batches of ``synthetic_parallax`` training items,
    each with seeded colour-jitter parameters for the step's device-side
    augmentation (``aug_params``), on ``device``."""
    from ..data.augment import AugmentParams
    from ..data.datasets import SyntheticParallaxDataset
    from ..data.pipeline import collate

    b = cfg.batch_size
    ds = SyntheticParallaxDataset(steps * b, cfg.height, cfg.width,
                                  list(cfg.frame_ids), seed=cfg.seed)
    with ThreadPoolExecutor(8) as pool:
        items = list(pool.map(lambda i: ds.get_item(i, 0), range(steps * b)))
    rng = np.random.default_rng(cfg.seed)
    for item in items:
        del item["color_aug"]
        item["aug_params"] = AugmentParams.draw(rng, True).to_vector()
    return [{k: torch.from_numpy(v).to(device) for k, v in collate(
        items[s * b:(s + 1) * b]).items()} for s in range(steps)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reference(cfg, device, memo: dict) -> "_Reference":
    """The ``_Reference`` of ``cfg``'s one-process configuration, made
    once per worker (``memo``)."""
    import dataclasses

    one = dataclasses.replace(cfg, mesh_data=-1, mesh_fsdp=1, mesh_dcn=1)
    key = ("reference", one.to_json())
    if key not in memo:
        memo[key] = _Reference(one, device)
    return memo[key]


class _Reference:
    """Rank 0's one-process bundles (the step's dtype, and float32 under
    bfloat16), set to the mesh's state before each step."""

    def __init__(self, cfg, device):
        import dataclasses

        from ..train.bundle import ModelBundle
        from ..train.state import create_train_state
        from ..train.step import build_train_step

        cfgs = [cfg] + ([dataclasses.replace(cfg, compute_dtype="float32")]
                        if cfg.compute_dtype != "float32" else [])
        self.nets = []
        for c in cfgs:
            # no initial values: every step loads the mesh's state
            with torch.device("meta"):
                bundle = ModelBundle(c)
            bundle = bundle.to_empty(device=device).eval()
            state = create_train_state(bundle)
            self.nets.append((bundle, state, build_train_step(bundle)))

    def step(self, snap, batch, noise):
        sd, osd, step = snap
        out = []
        for bundle, state, step_fn in self.nets:
            bundle.load_state_dict(sd)
            # a copy: the optimizer keeps tensors of its own device
            state.optimizer.load_state_dict(_copy(osd))
            state.step = step
            losses = step_fn(state, batch, noise=noise)
            out.append(({k: float(v) for k, v in losses.items()},
                        _copy(bundle.state_dict())))
        return out


def _compare(after, before, refs, param_names, lr):
    """The mesh's state after a step against the reference's."""
    (ref_losses, ref_sd), *f32 = refs
    stats = [n for n in ref_sd if "running" in n]
    diff = torch.cat([(after[n] - ref_sd[n]).abs().reshape(-1)
                      for n in param_names])
    out = {"ref_losses": ref_losses,
           "param_max": float(diff.max()),
           "param_beyond_0.1lr": float((diff > 0.1 * lr).float().mean()),
           "stats_max": max(float((after[n] - ref_sd[n]).abs().max())
                            for n in stats)}
    if f32:
        f32_losses, f32_sd = f32[0]

        def flipped(a, b):
            return sum(int((torch.sign(a[n] - before[n])
                            != torch.sign(b[n] - before[n])).sum())
                       for n in param_names) / sum(
                before[n].numel() for n in param_names)

        out.update(f32_losses=f32_losses,
                   flipped=flipped(after, ref_sd),
                   flipped_gap=flipped(ref_sd, f32_sd),
                   stats_gap=max(float((ref_sd[n] - f32_sd[n]).abs().max())
                                 for n in stats))
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def run_case(case: dict, device, out: Path, memo: dict) -> dict:
    """One case on this rank; -> its results (see the module docstring).
    ``memo`` keeps the batches and the one-process bundles from case to
    case."""
    from ..config import Options
    from ..data.pipeline import process_local_rows
    from ..ops import kernels as K
    from ..parallel import mesh as M
    from ..train import checkpoint as ck
    from ..train.bundle import ModelBundle
    from ..train.state import create_train_state, held_bytes
    from ..train.step import build_train_step

    if case.get("kind") == "batch_norm":
        return batch_norm_case(case, device)
    if case.get("kind") == "trainer":
        return trainer_case(case, device)
    parts: Dict[str, float] = {}  # wall seconds by part of the case

    @contextlib.contextmanager
    def part(name):
        start = time.perf_counter()
        yield
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - start

    begun = time.perf_counter()
    cfg = Options(**case["options"])
    mesh = M.make_mesh(cfg.mesh_data, cfg.mesh_fsdp, cfg.mesh_dcn,
                       local_world=case.get("local_world"))
    rank, steps = mesh.rank, case.get("steps", 1)
    key = ("batches", case.get("batch"), cfg.height, cfg.width,
           cfg.batch_size, steps, cfg.seed)
    if key not in memo:
        if case.get("batch"):
            given = torch.load(case["batch"], weights_only=True)
            memo[key] = ([{k: v.to(device) for k, v in b.items()}
                          for b in given["batches"]],
                         [None if n is None else
                          {s: t.to(device) for s, t in n.items()}
                          for n in given["noise"]])
        else:
            memo[key] = make_batches(cfg, steps, device), [None] * steps
    batches, noises = memo[key]
    rows = torch.from_numpy(process_local_rows(
        mesh, cfg.batch_size, cfg.grad_accum)).to(device)
    local = [{k: v[rows] for k, v in b.items()} for b in batches]

    def build(empty=False):
        if empty:  # for a restore, which sets every tensor
            with torch.device("meta"):
                bundle = ModelBundle(cfg)
            bundle = bundle.to_empty(device=device).eval()
        else:
            bundle = ModelBundle.create(cfg, seed=cfg.seed, device=device)
        if case.get("init"):
            bundle.load_state_dict(torch.load(case["init"],
                                              weights_only=True))
        state = create_train_state(bundle, 1, mesh)
        return bundle, state, build_train_step(bundle, mesh)

    bundle, state, step_fn = build()
    param_names = [n for n, _ in bundle.named_main_parameters()]
    res = {"mesh": [mesh.dcn, mesh.data, mesh.fsdp], "lr": cfg.learning_rate,
           "bf16": cfg.compute_dtype == "bfloat16", "steps": []}
    if case.get("restore"):
        ck.restore_checkpoint(case["restore"], bundle, state)
        saved = torch.load(os.path.join(case["restore"],
                                        f"{state.step}.pt"),
                           map_location="cpu", weights_only=True)
        res["restored"] = {"equal": state_digest(*snapshot(bundle, state))
                           == state_digest(saved["bundle"],
                                           saved["optimizer"],
                                           saved["step"])}
    compare = int(case.get("compare", 0))  # the first steps compared
    ref = _reference(cfg, device, memo) if compare and rank == 0 else None
    parts["setup"] = time.perf_counter() - begun
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ckpt_dir = str(out / case["name"] / "ckpt")
    launches: Dict[str, int] = {}
    digests = []
    for k in range(steps):
        with part("snapshots"):
            before = snapshot(bundle, state) if k < compare else None
        mesh.barrier(device)
        K.reset_counts()
        collectives = M.collectives()
        _sync(device)
        start = time.perf_counter()
        losses = step_fn(state, local[k], noise=noises[k])
        losses = {n: float(v) for n, v in losses.items()}
        _sync(device)
        ms = (time.perf_counter() - start) * 1e3
        record = {"losses": losses, "ms": ms,
                  "collectives": M.collectives() - collectives,
                  "launches": K.counts()}
        for name, n in record["launches"].items():
            launches[name] = launches.get(name, 0) + n
        parts["steps"] = parts.get("steps", 0.0) + ms / 1e3
        if case.get("ckpt_at") == k + 1:
            with part("checkpoint"):
                ck.save_checkpoint(ckpt_dir, bundle, state, cfg)
            res["ckpt"] = {"path": ckpt_dir, "step": state.step}
        # every rank (a collective); the moments from the checkpoint on
        whole = bool(case.get("ckpt_at")) and k + 1 >= case["ckpt_at"]
        with part("snapshots"):
            after = snapshot(bundle, state, moments=whole)
            record["digest"] = digest(after[0])
            digests.append((state_digest(*after) if whole else None,
                            losses))
        if case.get("ckpt_at") == k + 1:
            res["ckpt"]["digest"] = digests[-1][0]
        if ref is not None and before is not None:
            with part("one-process steps"):
                refs = ref.step(before, batches[k], noises[k])
                record["compare"] = _compare(after[0], before[0], refs,
                                             param_names, cfg.learning_rate)
        res["steps"].append(record)
    res["launches"] = launches
    res["bytes"] = held_bytes(bundle, state)
    res["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else None)
    if case.get("return_after") and rank == 0:
        torch.save({k: v.cpu() for k, v in after[0].items()},
                   out / case["name"] / "after.pt")
    begun = time.perf_counter()
    if case.get("ckpt_at"):
        k0 = case["ckpt_at"]
        del bundle, state, step_fn
        bundle, state, step_fn = build(empty=True)
        ck.restore_checkpoint(ckpt_dir, bundle, state)
        equal = state_digest(*snapshot(bundle, state)) == digests[k0 - 1][0]
        for k in range(k0, steps):
            losses = step_fn(state, local[k], noise=noises[k])
            losses = {n: float(v) for n, v in losses.items()}
            # every rank takes the snapshot (a collective under fsdp)
            now = state_digest(*snapshot(bundle, state))
            equal = equal and losses == digests[k][1] and now == digests[k][0]
        res["resumed"] = {"equal": bool(equal), "from_step": k0}
    parts["resume"] = time.perf_counter() - begun
    res["seconds_by_part"] = parts
    return res


def trainer_case(case: dict, device) -> dict:
    """``train.loop.Trainer`` with the case's options over the process
    group, as ``cli.train`` runs it under torchrun; -> the digest of its
    final parameters and statistics."""
    from ..config import Options
    from ..train.loop import Trainer
    from ..train.state import full_params

    trainer = Trainer(Options(**case["options"]), device=device)
    trainer.train()
    with full_params(trainer.state):
        final = digest(trainer.bundle.state_dict())
    mesh = trainer.mesh
    return {"steps": [{"digest": final}], "step": trainer.state.step,
            "mesh": [mesh.dcn, mesh.data, mesh.fsdp]}


def batch_norm_case(case: dict, device) -> dict:
    """``models.layers.BatchNorm2d`` over the ranks' rows of a seeded
    (B, C, H, W) batch against one BatchNorm over the whole batch: the
    output, the running statistics and the gradients of the input, the
    weight and the bias of a weighted sum of the output (rank 0 compares;
    the mesh's weight and bias gradients are summed over the ranks)."""
    from ..models.layers import BatchNorm2d
    from ..parallel import mesh as M

    b, c, h, w = case.get("shape", (4, 8, 6, 10))
    mesh = M.make_mesh()
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    x = (torch.randn((b, c, h, w), generator=gen) * 2 + 0.5).to(device)
    wsum = torch.randn((b, c, h, w), generator=gen).to(device)
    rows = mesh.batch_slices(b)[0]

    def run(bn, xs, ws):
        xs = xs.clone().requires_grad_(True)
        bn.weight.data.copy_(torch.linspace(0.5, 1.5, c))
        bn.bias.data.copy_(torch.linspace(-0.2, 0.2, c))
        out = bn(xs)
        (out * ws).sum().backward()
        return out.detach(), xs.grad

    bn = BatchNorm2d(c).to(device).train()
    M.share_batch_statistics(bn, mesh.group)
    out, gx = run(bn, x[rows], wsum[rows])
    outs = torch.cat(M.all_gather(out, mesh.group))
    gxs = torch.cat(M.all_gather(gx, mesh.group))
    gw = mesh.all_reduce_(bn.weight.grad.clone())
    gb = mesh.all_reduce_(bn.bias.grad.clone())
    one = BatchNorm2d(c).to(device).train()
    ref_out, ref_gx = run(one, x, wsum)

    def err(a, b):
        return float((a - b).abs().max())

    return {"steps": [], "mesh": [1, mesh.size, 1],
            "out": err(outs, ref_out), "grad_x": err(gxs, ref_gx),
            "grad_weight": err(gw, one.weight.grad),
            "grad_bias": err(gb, one.bias.grad),
            "running_mean": err(bn.running_mean, one.running_mean),
            "running_var": err(bn.running_var, one.running_var),
            "digest": digest({"m": bn.running_mean, "v": bn.running_var})}


def _watch_parent(parent: int):
    """End this process when its parent is gone."""
    while True:
        if os.getppid() != parent:
            os._exit(3)
        time.sleep(0.5)


def worker(out_dir: str, device: str, threads: int, timeout: float) -> int:
    import torch.distributed as dist

    from ..parallel.mesh import rank_device
    from ..train.loop import deterministic_cudnn

    faulthandler.dump_traceback_later(timeout, exit=True)
    threading.Thread(target=_watch_parent, args=(os.getppid(),),
                     daemon=True).start()
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(out_dir)
    cases = json.loads((out / "cases.json").read_text())
    dist.init_process_group(backend_of(device), init_method="env://")
    try:
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        results, memo = {}, {}
        with deterministic_cudnn():
            for case in cases:
                (out / case["name"]).mkdir(exist_ok=True)
                start = time.perf_counter()
                results[case["name"]] = run_case(case, dev, out, memo)
                results[case["name"]]["seconds"] = (time.perf_counter()
                                                    - start)
        rank = dist.get_rank()
        (out / f"rank{rank}.json").write_text(json.dumps(results))
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (a card per rank, NCCL), cuda:0 (one card "
                        "that every rank shares, gloo) or cpu (gloo)")
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--mesh_dcn", type=int, default=1)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--compute_dtype", default="float32")
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.worker:
        return worker(a.worker, a.device, a.threads, a.timeout)
    case = {"name": "step", "compare": a.steps, "steps": a.steps,
            "local_world": a.procs if a.mesh_dcn == 1 else
            a.procs // a.mesh_dcn,
            "options": dict(height=a.height, width=a.width,
                            batch_size=a.batch_size, mesh_data=a.mesh_data,
                            mesh_fsdp=a.mesh_fsdp, mesh_dcn=a.mesh_dcn,
                            grad_accum=a.grad_accum, learning_rate=1e-4,
                            compute_dtype=a.compute_dtype,
                            weights_init="scratch")}
    results = launch([case], a.procs, a.device, a.out_dir, a.timeout,
                     a.threads)
    failed = check(results, "step")
    for k, s in enumerate(results[0]["step"]["steps"]):
        cmp = s.get("compare", {})
        print(json.dumps({"step": k, "loss": s["losses"]["loss"],
                          "ref_loss": cmp.get("ref_losses", {}).get("loss"),
                          "param_max_over_lr": cmp.get("param_max", 0) / 1e-4,
                          "param_beyond_0.1lr": cmp.get("param_beyond_0.1lr"),
                          "stats_max": cmp.get("stats_max"),
                          "ms": [r["step"]["steps"][k]["ms"]
                                 for r in results],
                          "collectives": s["collectives"]}))
    print(json.dumps({"bytes": [r["step"]["bytes"] for r in results],
                      "ok": not failed, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
