"""Training traffic: the port's training step fed by its Loader, as the
trainer runs them.

Set-up builds one ModelBundle with the seed's weights, its Adam state
(``create_train_state``), the step (``build_train_step``) and a ``Loader``
over an in-memory pool of the mix's seeded items, all as
``train.loop.Trainer`` builds them, and runs the whole loop under
``train.loop.deterministic_cudnn()``. The first ``checked_steps`` steps
(three) go through the window's own call and feed; the plain reference
follows them after the window (``compare``). ``warmup_steps`` more end the
set-up. The window then runs steps until ``seconds`` have passed and ends
with a synchronize: samples/s is batch x steps over that time. With
``trace`` a profiled sub-window of ``trace_steps`` steps follows.

Mix parameters: ``pool_items`` (items of three frames, reshuffled each
epoch), ``texture_components`` and ``frame_shift_px`` (the frames),
``k_norm`` (normalised intrinsics), ``jitter`` (the photometric jitter's
law), ``checked_steps``, ``warmup_steps``, ``trace_steps``.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import inputs
from ..harness import derive
from ..reference import monodepth2 as ref
from ..reference.precision import Precision
from ..trace import Profiled

ADAM_BETA1 = 0.9


class Pool:
    """The Loader's dataset: seeded uint8 frames (n, 3, H, W, 3) held in
    memory, with the intrinsics and, per (epoch, index), jitter factors
    for the step to apply on the device (the datasets' item schema under
    ``device_augment``)."""

    def __init__(self, frames: np.ndarray, k_norm, seed: int, law: dict):
        self.frames = frames
        self.k_norm = np.asarray(k_norm, np.float32)
        self.seed, self.law = seed, law

    def __len__(self):
        return self.frames.shape[0]

    def get_item(self, index: int, epoch: int = 0):
        return {"color": self.frames[index], "K_norm": self.k_norm,
                "aug_params": inputs.jitter_params(self.seed, epoch, index,
                                                   self.law)}


def options(cfg_file: dict, overrides: Optional[dict] = None):
    from unsupervised_pose_estimation_tpu_torch.config import Options

    fields = dict(cfg_file["options"], **(overrides or {}))
    for key in ("scales", "frame_ids"):
        fields[key] = tuple(fields[key])
    return Options(**fields).validate()


def ref_opts(opt) -> dict:
    return {"scales": tuple(opt.scales),
            "depth_decoder_variant": opt.depth_decoder_variant,
            "min_depth": opt.min_depth, "max_depth": opt.max_depth,
            "disparity_smoothness": opt.disparity_smoothness,
            "height": opt.height, "width": opt.width,
            "batch_size": opt.batch_size}


def layout(opt):
    return ref.layout(opt.depth_decoder_variant, opt.scales)


def set_precision(cfg_file: dict):
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg_file["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg_file["tf32"])


def make_loader(opt, mix: dict, seed: int, device):
    from unsupervised_pose_estimation_tpu_torch.data.pipeline import Loader

    frames = inputs.textures(seed, "train", mix["pool_items"], opt.frame_ids,
                             opt.height, opt.width,
                             tuple(mix["frame_shift_px"]),
                             mix["texture_components"], device)
    pool = Pool(frames, mix["k_norm"], seed, mix["jitter"])
    return Loader(pool, opt.batch_size, shuffle=True, device=device,
                  num_workers=opt.num_workers,
                  num_worker_procs=opt.num_worker_procs,
                  prefetch=opt.prefetch, seed=derive(seed, "loader"),
                  infinite=True)


def noise_shape(opt):
    return (opt.batch_size, opt.height, opt.width, len(opt.frame_ids) - 1)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(t.float())
                        for t in tensors])


def run(cfg_file: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, spans, t_start: float, overrides: Optional[dict] = None,
        wrap_step: Optional[Callable] = None,
        keep: Optional[dict] = None) -> dict:
    """One run of the cell: set-up, the first steps, the window, the
    profiled sub-window, then the reference's comparison. ``wrap_step``
    (tests) replaces the step by a broken one. ``keep`` (``calibrate.py``)
    receives both sides' first gradients and changes leaf by leaf."""
    from unsupervised_pose_estimation_tpu_torch.train.bundle import \
        ModelBundle
    from unsupervised_pose_estimation_tpu_torch.train.loop import \
        deterministic_cudnn
    from unsupervised_pose_estimation_tpu_torch.train.state import \
        create_train_state
    from unsupervised_pose_estimation_tpu_torch.train.step import \
        build_train_step

    opt = options(cfg_file, overrides)
    set_precision(cfg_file)
    lay = layout(opt)
    with torch.device("meta"):
        bundle = ModelBundle(opt)
    bundle = bundle.to_empty(device=device)
    bundle.load_state_dict(inputs.weights(lay, seed, device))
    bundle.eval()
    state = create_train_state(bundle, cfg_file["steps_per_epoch"])
    step = build_train_step(bundle)
    if wrap_step is not None:
        step = wrap_step(step, bundle, state)
    loader = make_loader(opt, mix, seed, device)
    batches = iter(loader)
    names = [n for n, _ in bundle.named_main_parameters()]
    params = bundle.main_parameters()
    shape = noise_shape(opt)
    scales = tuple(opt.scales)
    count = [0]

    def one_step():
        count[0] += 1
        with spans.span("loader wait"):
            batch = next(batches)
        noise = inputs.noise(seed, count[0], shape, scales, device)
        with spans.span("step enqueue"):
            losses = step(state, batch, noise=noise)
        return batch, losses

    out: Dict[str, object] = {}
    checked, checked_losses = [], []
    with deterministic_cudnn():
        for k in range(mix["checked_steps"]):
            batch, losses = one_step()
            checked.append({key: v.clone() for key, v in batch.items()})
            checked_losses.append(losses["loss"].detach().clone())
            if k == 0:
                moments = [state.optimizer.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) for p in params]
                grad_norms = _norms(moments) / (1.0 - ADAM_BETA1)
                if keep is not None:
                    keep["grads"] = {n: m.detach() / (1.0 - ADAM_BETA1)
                                     for n, m in zip(names, moments)}
        start = inputs.weights(lay, seed, device)
        change_norms = _norms([p.detach() - start[n]
                               for n, p in zip(names, params)])
        if keep is not None:
            keep["changes"] = {n: p.detach() - start[n]
                               for n, p in zip(names, params)}
            keep["lr"] = opt.learning_rate
        del start
        for _ in range(mix["warmup_steps"]):
            one_step()
        _sync(device)
        out["setup_s"] = time.perf_counter() - t_start

        # the window
        spans.reset()
        peak0 = 0
        if device.type == "cuda":
            peak0 = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        wait0, batches0 = loader.wait_seconds, loader.batches
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            one_step()
            steps += 1
        _sync(device)
        window = time.perf_counter() - t0
        out["window_s"] = window
        out["steps"] = out["attempted"] = steps
        out["failed"] = 0
        out["samples_per_s"] = steps * opt.batch_size / window
        out["loader_wait_s"] = loader.wait_seconds - wait0
        out["loader_batches"] = loader.batches - batches0
        out["step_host_s"] = list(spans.durations.get("step enqueue", []))
        out["peak_window_bytes"] = (torch.cuda.max_memory_allocated(device)
                                    if device.type == "cuda" else 0)
        if trace:
            with Profiled(spans, mix["trace_steps"]) as prof:
                for _ in range(mix["trace_steps"]):
                    one_step()
            out["trace"] = prof.trace
        _sync(device)
    out["memory_peak_bytes"] = (max(peak0, torch.cuda.max_memory_allocated(
        device)) if device.type == "cuda" else 0)

    program = {"losses": [float(v) for v in checked_losses],
               "grad_norms": grad_norms.cpu(),
               "change_norms": change_norms.cpu(), "names": names}
    batches.close()
    loader.close()
    del bundle, state, step, loader, batches, params, moments
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    noises = [inputs.noise(seed, k + 1, shape, scales, device)
              for k in range(len(checked))]
    out["readings"] = compare(program, reference(opt, lay, seed, checked,
                                                 noises, "float32",
                                                 device, keep=keep))
    out["options"] = opt
    return out


def reference(opt, lay, seed: int, batches, noises, precision: str,
              device, rows: Optional[slice] = None,
              keep: Optional[dict] = None) -> dict:
    """The plain reference over the checked steps' batches: losses, the
    first gradient's norm and the change's norm by leaf. ``rows`` trains
    it on those rows of each batch only (a planted fault); ``keep`` takes
    the first gradients and changes themselves."""
    P = {n: t.clone() for n, t in inputs.weights(lay, seed, device).items()}
    start = {n: t.clone() for n, t in P.items() if ref.is_parameter(n)}
    if rows is not None:
        batches = [{k: v[rows] for k, v in b.items()} for b in batches]
        noises = [{s: t[rows] for s, t in n.items()} for n in noises]
    losses, first = ref.train(P, ref_opts(opt), batches, noises,
                              Precision(precision), opt.learning_rate)
    names = list(start)
    if keep is not None:
        keep["ref_grads"] = first
        keep["ref_changes"] = {n: P[n] - start[n] for n in names}
    return {"losses": losses, "names": names,
            "grad_norms": _norms([first[n] for n in names]).cpu(),
            "change_norms": _norms([P[n] - start[n] for n in names]).cpu()}


def compare(program: dict, reference_: dict) -> Dict[str, float]:
    """The three compared numbers:

    - loss_gap: the largest |program - reference| / |reference| of the
      checked steps' losses;
    - grad_gap: over leaves, the largest gap between the norms of the
      first gradient (the program's worked out from Adam's first moment
      after one step), against the larger of the leaf's reference norm
      and the median leaf's;
    - update_gap: the same of the parameters' change over the checked
      steps, over the leaves whose reference gradient is at least a
      thousandth of the median leaf's (the others move by round-off).
    """
    if sorted(program["names"]) != sorted(reference_["names"]):
        raise ValueError("the program's leaves are not the reference's")
    order = [reference_["names"].index(n) for n in program["names"]]
    reference_ = dict(reference_, **{k: reference_[k][order] for k in
                                     ("grad_norms", "change_norms")})
    step_gaps = [abs(p - r) / abs(r) for p, r in
                 zip(program["losses"], reference_["losses"])]
    gr, gp = reference_["grad_norms"], program["grad_norms"]
    med = float(gr.median())
    grad = (gp - gr).abs() / gr.clamp(min=med)
    keep = gr >= 1e-3 * med
    cr, cp = reference_["change_norms"][keep], program["change_norms"][keep]
    cmed = float(cr.median())
    update = (cp - cr).abs() / cr.clamp(min=cmed)
    kept = [n for n, k in zip(program["names"], keep) if k]
    return {"loss_gap": max(step_gaps), "grad_gap": float(grad.max()),
            "update_gap": float(update.max()),
            "loss1_gap": step_gaps[0], "step_gaps": step_gaps,
            "grad_gap_median": float(grad.median()),
            "update_gap_median": float(update.median()),
            "grad_worst": program["names"][int(grad.argmax())],
            "update_worst": kept[int(update.argmax())],
            "left_out_leaves": int((~keep).sum())}


def first_batches(cfg_file: dict, mix: dict, seed: int, device,
                  overrides: Optional[dict] = None):
    """The checked steps' batches and noise as a run's Loader gives them,
    without the program (for the control and the planted faults)."""
    opt = options(cfg_file, overrides)
    loader = make_loader(opt, mix, seed, device)
    it = iter(loader)
    batches = [{k: v.clone() for k, v in next(it).items()}
               for _ in range(mix["checked_steps"])]
    it.close()
    loader.close()
    noises = [inputs.noise(seed, k + 1, noise_shape(opt), tuple(opt.scales),
                           device) for k in range(len(batches))]
    return opt, batches, noises


def control(cfg_file: dict, mix: dict, seed: int, device, precision: str,
            rows: Optional[slice] = None,
            overrides: Optional[dict] = None) -> Dict[str, float]:
    """The compared numbers of the reference in ``precision`` (or on
    ``rows`` only) put in the program's place."""
    set_precision(cfg_file)
    opt, batches, noises = first_batches(cfg_file, mix, seed, device,
                                         overrides)
    lay = layout(opt)
    fake = reference(opt, lay, seed, batches, noises, precision, device,
                     rows)
    return compare(fake, reference(opt, lay, seed, batches, noises,
                                   "float32", device))


def summary(out: dict) -> dict:
    """End-to-end numbers and the readers' context."""
    opt = out["options"]
    return {"metrics": {"train_samples_per_s": out["samples_per_s"],
                        "setup_s": out["setup_s"]},
            "ctx": {"kind": "train", "options": opt,
                    "dtype": opt.compute_dtype,
                    "window_s": out["window_s"], "steps": out["steps"],
                    "batch": opt.batch_size,
                    "pixels": opt.batch_size * opt.height * opt.width,
                    "loader_wait_s": out["loader_wait_s"],
                    "loader_batches": out["loader_batches"],
                    "step_host_s": out["step_host_s"],
                    "step_host_median_s": (statistics.median(
                        out["step_host_s"]) if out["step_host_s"] else None),
                    "peak_window_bytes": out["peak_window_bytes"],
                    "trace": out.get("trace")}}
