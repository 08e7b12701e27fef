"""Train state: the Adam optimizer, the learning-rate schedule and the step
counter.

Port of ``unsupervised_pose_estimation_tpu/train/state.py``. There the state
is one pytree that the jitted step replaces; here the parameters and
BatchNorm statistics live in the bundle's modules (the step function holds
the bundle) and the Adam moments in the optimizer, which the step updates
in place, and ``TrainState`` holds the optimizer with the step counter
that the schedule and the automask noise read, and with
``adversarial_prior`` the discriminator's own Adam.

Over a mesh with fsdp > 1 (the reference's ``train_state_shardings``)
``ShardedParams`` keeps this rank's 1/fsdp of the main parameters, and the
Adam moments are those of that shard alone; BatchNorm statistics, the GAN
prior's networks, the discriminator's Adam and the step stay replicated.
Adam is elementwise, so a shard's update is the same as the unsharded
one's. On one CUDA device of one process the main Adam is made in its
``capturable`` mode (``adam_capturable``: the step counts and the bias
corrections on the device), so that the training step can replay it from a
CUDA graph (``train.step``); its state is saved as eager Adam's and loads
into either mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..config import Options
from ..parallel.mesh import Mesh, all_gather_into
from .bundle import ModelBundle

Schedule = Callable[[int], float]


def lr_schedule(cfg: Options, steps_per_epoch: int = 1) -> Schedule:
    """-> learning rate as a function of the optimizer step count.

    "none": constant ``cfg.learning_rate``. "step": torch StepLR(
    scheduler_step_size epochs, gamma 0.1) counted in optimizer steps,
    staircase, as optax ``exponential_decay`` in the reference."""
    lr = cfg.learning_rate
    if cfg.lr_scheduler == "none":
        return lambda count: lr
    if cfg.lr_scheduler == "step":
        every = max(1, cfg.scheduler_step_size * steps_per_epoch)
        return lambda count: lr * 0.1 ** math.floor(count / every)
    raise ValueError(f"unknown lr_scheduler '{cfg.lr_scheduler}'")


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam with betas (0.9, 0.999) and eps 1e-8: the arithmetic of optax
    ``adam`` (and of torch's Adam defaults, the reference trainer's
    optimizer), in its ``capturable`` mode when asked. The step sets the
    rate of each update from the schedule."""
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8, capturable=capturable)
    # its calls outside a capture (a graph's warm-up, the configurations
    # that run eagerly) are meant: no warning for them
    opt._warned_capturable_if_run_uncaptured = capturable
    return opt


def adam_capturable(device) -> bool:
    """Whether the main Adam of parameters on ``device`` is made
    ``capturable``: on a CUDA device in one process (no process group, or
    one of one), where the training step may replay it from a CUDA graph
    (``train.step.graph_capturable``). Elsewhere it is eager Adam, the
    reference's."""
    return torch.device(device).type == "cuda" and (
        not dist.is_initialized() or dist.get_world_size() == 1)


def is_capturable(optimizer: torch.optim.Optimizer) -> bool:
    return all(g["capturable"] for g in optimizer.param_groups)


def make_disc_optimizer(params: Iterable[torch.nn.Parameter],
                        cfg: Options) -> torch.optim.Adam:
    """The discriminator's Adam: rate ``cfg.discriminator_lr``, betas
    (``cfg.b1``, ``cfg.b2``), eps 1e-8, no schedule."""
    return torch.optim.Adam(params, lr=cfg.discriminator_lr,
                            betas=(cfg.b1, cfg.b2), eps=1e-8)


class ShardedParams:
    """fsdp: the main parameters laid end to end in one vector of
    ``numel`` elements (zero-padded to a multiple of fsdp) and cut into
    fsdp equal shards. This rank keeps shard ``mesh.fsdp_index`` as
    ``shard``, the one parameter its Adam updates. The modules' parameters
    are views into the full vector, whose storage ``gather()`` allocates
    and fills with every rank's shard (an all-gather over the fsdp group)
    and ``release()`` frees; between steps only the shard and its Adam
    moments are held, about 1/fsdp of the bytes."""

    def __init__(self, params: Iterable[nn.Parameter], mesh: Mesh):
        self.params = list(params)
        self.mesh = mesh
        first = self.params[0]
        if any(p.dtype != first.dtype or p.device != first.device
               for p in self.params):
            raise ValueError("fsdp shards parameters of one dtype on one "
                             "device")
        self.total = sum(p.numel() for p in self.params)
        self.shard_numel = -(-self.total // mesh.fsdp)
        self.numel = self.shard_numel * mesh.fsdp
        self.flat = torch.zeros(self.numel, dtype=first.dtype,
                                device=first.device)
        offset = 0
        with torch.no_grad():
            for p in self.params:
                view = self.flat[offset:offset + p.numel()]
                view.copy_(p.reshape(-1))
                p.data = view.view_as(p)
                offset += p.numel()
        self.shard = nn.Parameter(self._own(self.flat).clone())
        self.gathered = True

    def _own(self, flat: torch.Tensor) -> torch.Tensor:
        i = self.mesh.fsdp_index
        return flat[i * self.shard_numel:(i + 1) * self.shard_numel]

    def _chunks(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return list(flat.view(self.mesh.fsdp, self.shard_numel).unbind(0))

    def gather(self):
        """The full parameters, from every rank's shard (no-op when they
        are gathered)."""
        if self.gathered:
            return
        self.flat.untyped_storage().resize_(
            self.numel * self.flat.element_size())
        all_gather_into(self._chunks(self.flat), self.shard.detach(),
                        self.mesh.fsdp_group)
        self.gathered = True

    def release(self):
        """Free the full parameters and their gradients."""
        for p in self.params:
            p.grad = None
        self.flat.untyped_storage().resize_(0)
        self.gathered = False

    def scatter(self):
        """Take this rank's shard from the full parameters, after new
        values were loaded into them."""
        with torch.no_grad():
            self.shard.copy_(self._own(self.flat))

    def step(self, optimizer: torch.optim.Optimizer, flat_grad: torch.Tensor):
        """One update of the shard by ``optimizer`` from the full gradient
        ``flat_grad`` (averaged over the mesh, ``numel`` long); then the
        full parameters are freed."""
        self.shard.grad = self._own(flat_grad)
        optimizer.step()
        self.shard.grad = None
        self.release()

    def optimizer_state_dict(self, optimizer: torch.optim.Optimizer
                             ) -> dict:
        """``optimizer``'s state (Adam over ``shard``) as the state_dict of
        Adam over the parameters one by one, the checkpoints' format: the
        moments gathered from every rank (a collective) and cut per
        parameter."""
        saved = optimizer.state_dict()
        group = dict(saved["param_groups"][0],
                     params=list(range(len(self.params))))
        own = saved["state"].get(0)
        state: Dict[int, dict] = {}
        if own:
            full = {}
            for key in ("exp_avg", "exp_avg_sq"):
                buf = own[key].new_empty(self.numel)
                all_gather_into(self._chunks(buf), own[key],
                                self.mesh.fsdp_group)
                full[key] = buf
            offset = 0
            for i, p in enumerate(self.params):
                n = p.numel()
                state[i] = {"step": own["step"].clone(),
                            **{key: buf[offset:offset + n].view_as(p).clone()
                               for key, buf in full.items()}}
                offset += n
        return {"state": state, "param_groups": [group]}

    def load_optimizer_state_dict(self, optimizer: torch.optim.Optimizer,
                                  saved: dict):
        """Load a state_dict of Adam over the parameters one by one (the
        checkpoints' format) into ``optimizer``, this rank's shard of each
        moment."""
        group = dict(saved["param_groups"][0], params=[0])
        state = {}
        if saved["state"]:
            entries = [saved["state"][i] for i in range(len(self.params))]
            step = entries[0]["step"]
            if any(float(e["step"]) != float(step) for e in entries):
                raise ValueError("the parameters' Adam steps differ; fsdp "
                                 "keeps one step for all of them")
            own = {"step": step.clone()}
            for key in ("exp_avg", "exp_avg_sq"):
                full = entries[0][key].new_zeros(self.numel)
                torch.cat([e[key].reshape(-1) for e in entries],
                          out=full[:self.total])
                own[key] = self._own(full).clone()
            state[0] = own
        optimizer.load_state_dict({"state": state, "param_groups": [group]})


@dataclasses.dataclass
class TrainState:
    """``step`` counts optimizer updates; ``schedule(step)`` is the rate of
    the next one. ``disc_optimizer`` is the discriminator's Adam, or
    None without one. ``mesh`` is the run's ``parallel.mesh.Mesh`` (None
    on one device); under fsdp ``shards`` holds this rank's shard of the
    main parameters, and ``optimizer`` is Adam over that shard."""

    step: int
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    disc_optimizer: Optional[torch.optim.Optimizer] = None
    mesh: Optional[Mesh] = None
    shards: Optional[ShardedParams] = None


@contextlib.contextmanager
def full_params(state: Optional[TrainState]):
    """The full main parameters while the body runs: under fsdp gathered,
    and freed again after if they were not gathered before; otherwise
    (no ``shards``, or no state) nothing to do."""
    shards = getattr(state, "shards", None)
    if shards is None or shards.gathered:
        yield
        return
    shards.gather()
    try:
        yield
    finally:
        shards.release()


def optimizer_state_dict(state: TrainState) -> dict:
    """The main Adam's state_dict in the checkpoints' format (Adam over
    the parameters one by one, eager: a float rate and the step counts on
    the host), whatever its mode, gathered under fsdp (a collective)."""
    if state.shards is None:
        return _in_mode(state.optimizer.state_dict(), False)
    return state.shards.optimizer_state_dict(state.optimizer)


def _in_mode(saved: dict, capturable: bool) -> dict:
    """An Adam state_dict with its groups in ``capturable`` mode or out of
    it, the rate a float. Out of it the step counts are float32 on the
    host, as eager Adam keeps them; a capturable Adam moves them to its
    parameters' device as it loads them."""
    groups = [dict(g, capturable=capturable, lr=float(g["lr"]))
              for g in saved["param_groups"]]
    state = saved["state"]
    if not capturable:
        state = {i: {**st, "step": st["step"].to("cpu", torch.float32)}
                 if "step" in st else st for i, st in state.items()}
    return {"state": state, "param_groups": groups}


def load_optimizer_state_dict(state: TrainState, saved: dict):
    """Load a state_dict in the checkpoints' format into the main Adam
    (this rank's shard of it under fsdp), keeping the Adam's mode."""
    if state.shards is None:
        state.optimizer.load_state_dict(
            _in_mode(saved, is_capturable(state.optimizer)))
    else:
        state.shards.load_optimizer_state_dict(state.optimizer, saved)


def held_bytes(bundle: ModelBundle, state: TrainState) -> Dict[str, int]:
    """Bytes of the main parameters and of each Adam moment that this
    process holds now, and their totals over the whole model."""
    params = bundle.main_parameters()
    total = sum(p.numel() * p.element_size() for p in params)
    moments = [st for st in state.optimizer.state.values() if st]
    out = {"total": total}
    if state.shards is None:
        out["parameters"] = total
    else:
        out["parameters"] = (state.shards.flat.untyped_storage().nbytes()
                             + state.shards.shard.nbytes)
    for key in ("exp_avg", "exp_avg_sq"):
        out[key] = sum(st[key].nbytes for st in moments)
    return out


def create_train_state(bundle: ModelBundle, steps_per_epoch: int = 1,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """A fresh state at step 0: Adam over ``bundle.main_parameters()``
    (the reference's ``params``: the frozen generator and the
    discriminator are not in it; ``capturable`` where
    ``adam_capturable``) and, with a discriminator, its own
    Adam; placed on ``mesh`` (``shard_train_state``) when given."""
    schedule = lr_schedule(bundle.cfg, steps_per_epoch)
    params = bundle.main_parameters()
    optimizer = make_optimizer(params, schedule(0),
                               adam_capturable(params[0].device))
    disc = bundle.discriminator
    state = TrainState(step=0, optimizer=optimizer, schedule=schedule,
                       disc_optimizer=None if disc is None else
                       make_disc_optimizer(disc.parameters(), bundle.cfg))
    return state if mesh is None else shard_train_state(state, bundle, mesh)


def shard_train_state(state: TrainState, bundle: ModelBundle,
                      mesh: Mesh) -> TrainState:
    """Place ``state`` on ``mesh``: with fsdp > 1 the main parameters
    become ``ShardedParams`` (freed to this rank's shard) and the main Adam
    one over that shard, carrying over whatever moments ``state`` had
    (a restored checkpoint's); -> ``state``, changed in place."""
    state.mesh = mesh
    if mesh.fsdp == 1 or state.shards is not None:
        return state
    saved = state.optimizer.state_dict()
    shards = ShardedParams(bundle.main_parameters(), mesh)
    optimizer = make_optimizer([shards.shard], state.schedule(state.step))
    shards.load_optimizer_state_dict(optimizer, saved)
    state.optimizer, state.shards = optimizer, shards
    shards.release()
    return state
