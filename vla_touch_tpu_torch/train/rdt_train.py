"""RDT finetuning: the train state and the train step (counterpart of
``vla_touch_tpu/train/rdt_train.py``).

One :func:`train_step` is the JAX package's jitted step in its order:

- gradient accumulation over the batch's leading ``grad_accum``
  micro-batches: each micro-batch's gradients cast to ``accum_dtype`` and
  summed, then divided by the count in float32 (the loss likewise);
- ``clip_by_global_norm`` and AdamW or 8-bit AdamW
  (``train/optim.py::RDTOptimizer``);
- the update applied to the float32 master weights, or, for
  ``param_dtype='bfloat16'`` (no master copy), to bf16 parameters with
  stochastic rounding (``utils/ema.py::stochastic_round_bf16``);
- the warm-up EMA (``rdt_ema_decay`` at the step before the update), in
  float32 or in bf16 with stochastic rounding;
- the metrics ``loss`` and ``grad_norm`` (of the averaged gradients,
  before clipping).

The draws (each micro-batch's noise and timesteps, the rounding bits) come
from a ``torch.Generator`` or are given: the port cannot replay
``jax.random``.

:func:`make_sharded_train_step` is the same step over a ``(data, model)``
mesh (``parallel/mesh.py``), one process per rank, each given its rows of
every micro-batch (the global batch is the rank-major concatenation):

- data parallel: the gradients (of each rank's mean loss) summed over the
  data ranks and divided by their count, so loss and gradients are the
  global batch's;
- ZeRO-2: the optimizer moments and the EMA shadow live sharded over data
  (``mesh.zero_sharding``'s axis); each rank updates its shard and the new
  parameters are all-gathered.  8-bit moments are sharded by whole blocks
  of the JAX layout (the block count padded with zero blocks to a
  multiple of the data ranks), so every block's amax is one rank's and the
  numbers are the one-process step's;
- clipping: the global norm is the sum over ranks of each shard's squares
  (a replicated leaf counted once);
- ZeRO-3 (``tcfg.zero3``): parameters and the EMA shadow sharded too
  (``mesh.fsdp_param_shardings``); each RDT block gathers its weights just
  before its forward and, recomputed under ``torch.utils.checkpoint``,
  before its backward, whose gradients come back reduce-scattered; the
  other leaves are gathered once a micro-batch.  One shard-local update
  serves ZeRO-2 and ZeRO-3;
- tensor parallelism over ``model`` (``parallel/tp.py``): the blocks'
  matmuls on each rank's heads, K1 on each rank's ``H / n_model`` heads;
  it composes with both (the moments and shadow sharded over model like
  their parameter, and over data on ``zero_spec_for``'s axis with the TP
  spec as base).

Rounding bits are drawn full-size from a generator shared by all ranks
(every rank of a replicated leaf must round alike) and sliced.
:func:`gather_train_state` collects a sharded state leaf by leaf, for the
checkpoint rank 0 writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from vla_touch_tpu_torch.config import TrainConfig, torch_dtype
from vla_touch_tpu_torch.models.rdt import runner as R
from vla_touch_tpu_torch.ops import adam8bit as A8
from vla_touch_tpu_torch.parallel import mesh as mesh_lib
from vla_touch_tpu_torch.parallel import tp as tp_lib
from vla_touch_tpu_torch.parallel.comm import GatherFn, Piece, all_gather_list, all_reduce_sum
from vla_touch_tpu_torch.train.optim import RDTOptimizer, clip_by_global_norm, global_norm
from vla_touch_tpu_torch.utils import ema as ema_lib
from vla_touch_tpu_torch.utils.from_flax import flax_paths


@dataclasses.dataclass
class TrainState:
    """``module``'s parameters are the trained parameters (float32 masters,
    or bf16); names follow the module, their order the JAX tree's."""

    module: R.RDTRunnerModule
    opt_state: object
    ema: ema_lib.EmaState
    step: int
    # a sharded state's plan (make_sharded_train_step); None on one device
    plan: Optional["ShardPlan"] = None

    @property
    def params(self) -> dict:
        return dict(self.module.named_parameters())


def leaf_names(module: R.RDTRunnerModule) -> list:
    """The parameter names in the JAX tree's leaf order (sorted paths): the
    order of the sums over leaves (the global norm)."""
    return [n for n, _ in sorted(flax_paths(module).items(), key=lambda kv: kv[1][0])]


def make_optimizer(cfg: TrainConfig, module: R.RDTRunnerModule) -> RDTOptimizer:
    """The optimizer of ``module``'s parameters (8-bit moments blocked in
    the JAX layout)."""
    return RDTOptimizer(cfg, transposed={n for n, (_, t) in flax_paths(module).items() if t})


def _check_param_dtype(tcfg: TrainConfig) -> None:
    if tcfg.param_dtype != "float32" and not tcfg.use_8bit_adam:
        raise ValueError(
            "param_dtype='bfloat16' stores no float32 master copy; float32 "
            "AdamW would then keep bf16 moments.  Use use_8bit_adam=True (int8 "
            "moments, float32 update math).")


def init_train_state(rcfg: R.RDTRunnerConfig, tcfg: TrainConfig, seed: int = 0,
                     device=None, module: Optional[R.RDTRunnerModule] = None) -> TrainState:
    """A fresh state: ``module`` (float32 master weights from
    ``runner.init_rdt_train``; a seeded random one when None) cast to
    ``param_dtype``, zero optimizer state, the EMA shadow a copy of the
    parameters in ``ema_dtype``."""
    _check_param_dtype(tcfg)
    if module is None:
        module = R.init_rdt_train(rcfg, seed, device)
    module.to(torch_dtype(tcfg.param_dtype))
    params = dict(module.named_parameters())
    opt = make_optimizer(tcfg, module)
    return TrainState(module=module, opt_state=opt.init(params),
                      ema=ema_lib.init(params, torch_dtype(tcfg.ema_dtype)), step=0)


def train_draws(rcfg: R.RDTRunnerConfig, tcfg: TrainConfig, state: TrainState,
                batch: dict, generator: Optional[torch.Generator] = None) -> dict:
    """A step's draws from ``generator``: ``noise`` (n_micro, B, H, D),
    ``timesteps`` (n_micro, B) and, for bf16 parameters / EMA,
    ``apply_bits`` / ``ema_bits`` (name -> 16-bit integers)."""
    gt = batch["action_gt"]
    n_micro = gt.shape[0]
    draws = R.loss_draws(rcfg, (n_micro * gt.shape[1],) + tuple(gt.shape[2:]),
                         gt.device, generator)
    out = {"noise": draws["noise"].reshape(gt.shape),
           "timesteps": draws["timesteps"].reshape(gt.shape[:2])}

    def bits():
        return {n: torch.randint(0, 1 << 16, p.shape, generator=generator, device=p.device)
                for n, p in state.module.named_parameters()}
    if tcfg.param_dtype == "bfloat16":
        out["apply_bits"] = bits()
    if tcfg.ema_dtype == "bfloat16":
        out["ema_bits"] = bits()
    return out


def _grads(loss, leaves: list, dtype) -> list:
    """d loss / d leaves in ``dtype``; zeros for a leaf the loss does not
    reach (as JAX's grad: at depth 1 no block reads the image adaptor)."""
    return [torch.zeros_like(x, dtype=dtype) if g is None else g.to(dtype)
            for x, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]


def train_step(rcfg: R.RDTRunnerConfig, tcfg: TrainConfig, state: TrainState, batch: dict,
               draws: Optional[dict] = None, generator: Optional[torch.Generator] = None,
               optimizer: Optional[RDTOptimizer] = None):
    """One optimizer step over ``grad_accum`` micro-batches, in place on
    ``state`` -> (state, metrics as device tensors).

    ``batch`` leaves are shaped (grad_accum, micro_batch, ...) on the
    module's device.  ``draws``: :func:`train_draws`' dict (from
    ``generator`` when None)."""
    _check_param_dtype(tcfg)
    opt = optimizer or make_optimizer(tcfg, state.module)
    if draws is None:
        draws = train_draws(rcfg, tcfg, state, batch, generator)
    names = leaf_names(state.module)
    params = state.params
    leaves = [params[n] for n in names]
    acc_dtype = torch_dtype(tcfg.accum_dtype)
    n_micro = batch["action_gt"].shape[0]
    g_sum, loss_sum = None, torch.zeros((), device=leaves[0].device)
    for i in range(n_micro):
        mb = {k: v[i] for k, v in batch.items()}
        loss = R.rdt_compute_loss(rcfg, state.module, mb, noise=draws["noise"][i],
                                  timesteps=draws["timesteps"][i])
        g = _grads(loss, leaves, acc_dtype)
        if g_sum is None:
            g_sum = g
        else:
            torch._foreach_add_(g_sum, g)
        loss_sum = loss_sum + loss.detach()
        del g, loss
    grads = torch._foreach_div([x.float() for x in g_sum], float(n_micro))
    del g_sum
    g_norm = global_norm(grads)
    updates, state.opt_state = opt.update(dict(zip(names, grads)), state.opt_state,
                                          params, g_norm=g_norm)
    del grads
    with torch.no_grad():
        if tcfg.param_dtype == "bfloat16":
            for n in names:
                p = params[n]
                p.copy_(ema_lib.stochastic_round_bf16(p.float() + updates[n].float(),
                                                      draws["apply_bits"][n]))
        else:
            torch._foreach_add_(leaves, [updates[n] for n in names])
    del updates
    decay = ema_lib.rdt_ema_decay(state.step, inv_gamma=tcfg.ema_inv_gamma,
                                  power=tcfg.ema_power, max_value=tcfg.ema_decay)
    state.ema = ema_lib.update(state.ema, params, decay, noise=draws.get("ema_bits"))
    state.step += 1
    return state, {"loss": loss_sum / n_micro, "grad_norm": g_norm}


# ---- the sharded step ---------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class LeafPlan:
    """One parameter's layout over the mesh.  ``shape``: the full torch
    shape; ``tp``: its model-axis piece (parameter, moments and shadow);
    ``data``: the data-axis piece of the moments and shadow (ZeRO-3: of the
    parameter too), None where no axis divides (replicated over data);
    ``model_partial``: its gradient is a partial sum over the model
    ranks."""

    name: str
    shape: tuple
    transposed: bool
    tp: Optional[Piece]
    data: Optional[Piece]
    model_partial: bool

    def owned(self, plan) -> bool:
        """Whether this rank counts the leaf in the global norm: a piece
        counts on every rank, a replicated copy on rank 0 of its axis."""
        return ((self.tp is not None or plan.model_rank == 0)
                and (self.data is not None or plan.data_rank == 0))


@dataclasses.dataclass(eq=False)
class ShardPlan:
    """Every parameter's layout on this rank (:func:`make_shard_plan`) and
    the moves between the full tensor, the module's local parameter (TP
    piece; ZeRO-3: its data shard too) and the local moments / shadow (TP
    piece, data shard; 8-bit: this data rank's whole blocks)."""

    mesh: object
    zero3: bool
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object
    leaves: dict          # name -> LeafPlan, in the module's parameter order
    names: list           # leaf_names order (the JAX tree's)

    def param_local(self, lp: LeafPlan, full: torch.Tensor) -> torch.Tensor:
        t = full if lp.tp is None else lp.tp.take(full)
        return lp.data.take(t) if self.zero3 and lp.data is not None else t

    def state_local(self, lp: LeafPlan, full: torch.Tensor) -> torch.Tensor:
        t = full if lp.tp is None else lp.tp.take(full)
        return t if lp.data is None else lp.data.take(t)

    def param_to_state(self, lp: LeafPlan, local: torch.Tensor) -> torch.Tensor:
        return local if self.zero3 or lp.data is None else lp.data.take(local)

    def state_to_param(self, lp: LeafPlan, local: torch.Tensor) -> torch.Tensor:
        return local if self.zero3 or lp.data is None else lp.data.gather(local)

    def state_full(self, lp: LeafPlan, local: torch.Tensor) -> torch.Tensor:
        t = local if lp.data is None else lp.data.gather(local)
        return t if lp.tp is None else lp.tp.gather(t)

    def param_full(self, lp: LeafPlan, local: torch.Tensor) -> torch.Tensor:
        t = local if not (self.zero3 and lp.data is not None) else lp.data.gather(local)
        return t if lp.tp is None else lp.tp.gather(t)

    # 8-bit moments: whole blocks of the flattened JAX-layout leaf
    def n_blocks(self, lp: LeafPlan) -> tuple:
        """(blocks of the leaf, blocks a data rank holds)."""
        nb = A8.n_blocks(int(torch.Size(lp.shape).numel()))
        return nb, -(-nb // self.n_data)

    def to_blocks(self, lp: LeafPlan, full: torch.Tensor) -> torch.Tensor:
        """This data rank's blocks of a full torch-layout leaf, flat."""
        _, nbl = self.n_blocks(lp)
        flat = (full.t() if lp.transposed else full).reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, self.n_data * nbl * A8.BLOCK - flat.numel()))
        n = nbl * A8.BLOCK
        return flat[self.data_rank * n:(self.data_rank + 1) * n]

    def from_blocks(self, lp: LeafPlan, local: torch.Tensor) -> torch.Tensor:
        """The full torch-layout leaf from every data rank's flat blocks."""
        flat = torch.cat(all_gather_list(local, self.data_group))
        jshape = tuple(reversed(lp.shape)) if lp.transposed else lp.shape
        full = flat[: int(torch.Size(lp.shape).numel())].reshape(jshape)
        return full.t() if lp.transposed else full

    def gather_blocks(self, rows: torch.Tensor, nb: int) -> torch.Tensor:
        """Every data rank's block rows (codes or scales), the padding cut."""
        return torch.cat(all_gather_list(rows, self.data_group))[:nb]


def make_shard_plan(mesh, rcfg: R.RDTRunnerConfig, tcfg: TrainConfig) -> ShardPlan:
    """The layout of every RDT parameter on this rank (from a module on the
    meta device: names and shapes only)."""
    from vla_touch_tpu_torch.utils.from_flax import flax_paths

    with torch.device("meta"):
        full = R.RDTRunnerModule(rcfg.model)
    n_data, n_model = mesh_lib.mesh_sizes(mesh)
    d_rank, m_rank = mesh_lib.data_index(mesh), mesh_lib.model_index(mesh)
    d_group = mesh_lib.group(mesh, mesh_lib.DATA_AXIS)
    m_group = mesh_lib.group(mesh, mesh_lib.MODEL_AXIS)
    tp_pieces = tp_lib.rdt_tp_pieces(mesh, full)
    partial = tp_lib.rdt_model_partial(full, tp_pieces)
    specs = mesh_lib.fsdp_param_shardings(mesh, full)
    paths = flax_paths(full)
    leaves = {}
    for name, p in full.named_parameters():
        spec = specs[name]
        data = None
        if mesh_lib.DATA_AXIS in spec:
            axis = spec.index(mesh_lib.DATA_AXIS)
            data = Piece.split(axis, p.shape[axis], d_group, d_rank, n_data)
        leaves[name] = LeafPlan(name, tuple(p.shape), paths[name][1], tp_pieces.get(name),
                                data, name in partial)
    return ShardPlan(mesh, bool(tcfg.zero3), n_data, n_model, d_rank, m_rank, d_group,
                     m_group, leaves, leaf_names(full))


class _Zero3Blocks:
    """ZeRO-3's call of one RDT block: its parameter shards gathered over
    data (``GatherFn``: the gradient reduce-scattered back), the block run
    on them, the whole recomputed in the backward pass
    (``torch.utils.checkpoint``), so one block's full weights live at a
    time."""

    def __init__(self, plan: ShardPlan):
        self.per_block = {}
        for name, lp in plan.leaves.items():
            if name.startswith("model.blocks.") and lp.data is not None:
                i, rest = name[len("model.blocks."):].split(".", 1)
                self.per_block.setdefault(int(i), []).append((rest, lp.data))

    def __call__(self, i, blk, x, c, mask):
        from torch.utils.checkpoint import checkpoint

        local = self.per_block.get(i, [])
        names = [n for n, _ in local]

        def run(x, c, *shards):
            full = {n: GatherFn.apply(s, piece) for (n, piece), s in zip(local, shards)}
            return torch.func.functional_call(blk, full, (x, c, mask))

        shards = [blk.get_parameter(n) for n in names]
        if torch.is_grad_enabled():
            return checkpoint(run, x, c, *shards, use_reentrant=False)
        return run(x, c, *shards)


class _Bound:
    """``module`` called with some parameters replaced (ZeRO-3's gathered
    leaves outside the blocks)."""

    def __init__(self, module, params: dict):
        self.module, self.params = module, params

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self.module, self.params, args, kwargs)


def shard_train_state(mesh, state: TrainState, plan: ShardPlan) -> TrainState:
    """A full one-device state (e.g. fresh, or just read from a checkpoint)
    put on ``plan``'s layout in place: the TP linears on this rank's piece,
    ZeRO-3 parameters on their data shard, the moments and shadow on their
    shards (8-bit: this rank's blocks).  Returns ``state``."""
    module = state.module
    tp_lib.shard_rdt_tp_(module, mesh, {n: lp.tp for n, lp in plan.leaves.items()
                                        if lp.tp is not None})
    with torch.no_grad():
        for name, p in module.named_parameters():
            lp = plan.leaves[name]
            if plan.zero3 and lp.data is not None:
                p.data = lp.data.take(p.data)
        st = state.opt_state
        if isinstance(st, A8.Adam8bitState):
            for n, lp in plan.leaves.items():
                nb, nbl = plan.n_blocks(lp)
                lo, hi = plan.data_rank * nbl, (plan.data_rank + 1) * nbl
                for codes, scales in ((st.m_q, st.m_s), (st.v_q, st.v_s)):
                    codes[n] = torch.nn.functional.pad(
                        codes[n], (0, 0, 0, plan.n_data * nbl - nb))[lo:hi].contiguous()
                    scales[n] = torch.nn.functional.pad(
                        scales[n], (0, plan.n_data * nbl - nb))[lo:hi].contiguous()
        else:
            for moments in (st.mu, st.nu):
                for n, lp in plan.leaves.items():
                    moments[n] = plan.state_local(lp, moments[n])
        shadow = state.ema.shadow
        for n, lp in plan.leaves.items():
            shadow[n] = plan.state_local(lp, shadow[n])
    if plan.zero3:
        module.model.block_call = _Zero3Blocks(plan)
    state.plan = plan
    return state


def make_sharded_train_step(mesh, rcfg: R.RDTRunnerConfig, tcfg: TrainConfig):
    """(step_fn, plan): ``step_fn(state, batch, draws=None, generator=None,
    shared_generator=None, optimizer=None)`` runs :func:`sharded_train_step`
    on a state :func:`shard_train_state` put on ``plan``."""
    plan = make_shard_plan(mesh, rcfg, tcfg)

    def step_fn(state, batch, **kw):
        return sharded_train_step(plan, rcfg, tcfg, state, batch, **kw)

    return step_fn, plan


def sharded_train_draws(plan: ShardPlan, rcfg: R.RDTRunnerConfig, tcfg: TrainConfig,
                        batch: dict, generator: Optional[torch.Generator] = None,
                        shared_generator: Optional[torch.Generator] = None) -> dict:
    """:func:`train_draws` on a rank: noise and timesteps for its rows from
    ``generator``, the rounding bits full-size (the parameters' order and
    full shapes) from ``shared_generator`` (``generator`` when None: one
    rank draws as the one-device step)."""
    gt = batch["action_gt"]
    n_micro = gt.shape[0]
    draws = R.loss_draws(rcfg, (n_micro * gt.shape[1],) + tuple(gt.shape[2:]),
                         gt.device, generator)
    out = {"noise": draws["noise"].reshape(gt.shape),
           "timesteps": draws["timesteps"].reshape(gt.shape[:2])}
    bit_gen = generator if shared_generator is None else shared_generator

    def bits():
        return {n: torch.randint(0, 1 << 16, lp.shape, generator=bit_gen, device=gt.device)
                for n, lp in plan.leaves.items()}
    if tcfg.param_dtype == "bfloat16":
        out["apply_bits"] = bits()
    if tcfg.ema_dtype == "bfloat16":
        out["ema_bits"] = bits()
    return out


def _zero3_outer(plan: ShardPlan, module) -> dict:
    """ZeRO-3's leaves outside the blocks, gathered (autograd through the
    gather) for one micro-batch."""
    params = dict(module.named_parameters())
    return {n: GatherFn.apply(params[n], lp.data) for n, lp in plan.leaves.items()
            if not n.startswith("model.blocks.") and lp.data is not None}


def sharded_train_step(plan: ShardPlan, rcfg: R.RDTRunnerConfig, tcfg: TrainConfig,
                       state: TrainState, batch: dict, draws: Optional[dict] = None,
                       generator: Optional[torch.Generator] = None,
                       shared_generator: Optional[torch.Generator] = None,
                       optimizer: Optional[RDTOptimizer] = None):
    """:func:`train_step` on this rank's rows of the global batch (every
    rank of the mesh calls it): (state, metrics of the global batch)."""
    _check_param_dtype(tcfg)
    opt = optimizer or make_optimizer(tcfg, state.module)
    if draws is None:
        draws = sharded_train_draws(plan, rcfg, tcfg, batch, generator, shared_generator)
    module = state.module
    names = plan.names
    params = dict(module.named_parameters())
    leaves = [params[n] for n in names]
    acc_dtype = torch_dtype(tcfg.accum_dtype)
    n_micro = batch["action_gt"].shape[0]
    g_sum, loss_sum = None, torch.zeros((), device=leaves[0].device)
    for i in range(n_micro):
        mb = {k: v[i] for k, v in batch.items()}
        outer = _zero3_outer(plan, module) if plan.zero3 else {}
        loss = R.rdt_compute_loss(rcfg, _Bound(module, outer) if outer else module, mb,
                                  noise=draws["noise"][i], timesteps=draws["timesteps"][i])
        g = _grads(loss, leaves, acc_dtype)
        if g_sum is None:
            g_sum = g
        else:
            torch._foreach_add_(g_sum, g)
        loss_sum = loss_sum + loss.detach()
        del g, loss, outer
    grads = torch._foreach_div([x.float() for x in g_sum], float(n_micro))
    del g_sum
    # the data-parallel mean (ZeRO-3's gathered leaves were summed in the
    # backward pass), the model ranks' partial sums, then the state layout
    g_state = {}
    for n, g in zip(names, grads):
        lp = plan.leaves[n]
        if not (plan.zero3 and lp.data is not None):
            g = all_reduce_sum(g, plan.data_group)
        g = g / float(plan.n_data)
        if lp.model_partial:
            g = all_reduce_sum(g, plan.model_group)
        g_state[n] = plan.param_to_state(lp, g)
    del grads
    sq = torch.stack([torch.sum(torch.square(g_state[n].float())) if plan.leaves[n].owned(plan)
                      else torch.zeros((), device=leaves[0].device) for n in names])
    sq = all_reduce_sum(sq)
    total = sq[0]
    for i in range(1, len(names)):
        total = total + sq[i]
    g_norm = torch.sqrt(total)
    clipped = clip_by_global_norm([g_state[n] for n in names], tcfg.max_grad_norm, g_norm)
    g_state = dict(zip(names, clipped))
    del clipped
    with torch.no_grad():
        if tcfg.use_8bit_adam:
            p_state = _update_8bit(plan, tcfg, opt, state, params, g_state, draws)
        else:
            p_state = {n: plan.param_to_state(plan.leaves[n], params[n]) for n in names}
            updates, state.opt_state = opt._adamw(g_state, state.opt_state, p_state)
            del g_state
            for n in names:
                if p_state[n] is params[n]:
                    params[n].add_(updates[n])      # in place, as the one-device step
                else:
                    p_state[n] = p_state[n] + updates[n]
                    params[n].copy_(plan.state_to_param(plan.leaves[n], p_state[n]))
            del updates
    decay = ema_lib.rdt_ema_decay(state.step, inv_gamma=tcfg.ema_inv_gamma,
                                  power=tcfg.ema_power, max_value=tcfg.ema_decay)
    ema_bits = draws.get("ema_bits")
    if ema_bits is not None:
        ema_bits = {n: plan.state_local(plan.leaves[n], ema_bits[n]) for n in names}
    state.ema = ema_lib.update(state.ema, p_state, decay, noise=ema_bits)
    state.step += 1
    loss = all_reduce_sum(loss_sum / n_micro, plan.data_group) / float(plan.n_data)
    return state, {"loss": loss, "grad_norm": g_norm}


def _update_8bit(plan: ShardPlan, tcfg: TrainConfig, opt: RDTOptimizer, state: TrainState,
                 params: dict, g_state: dict, draws: dict) -> dict:
    """The 8-bit AdamW update on this data rank's whole blocks of each full
    leaf; the new parameters gathered and put back on the local layout.
    Returns the new parameters in the state layout (for the EMA)."""
    names = plan.names
    g_blocks, p_blocks = {}, {}
    for n in names:
        lp = plan.leaves[n]
        g_blocks[n] = plan.to_blocks(lp, plan.state_full(lp, g_state[n]))
        p_blocks[n] = plan.to_blocks(lp, plan.param_full(lp, params[n]))
    t = tcfg
    updates, state.opt_state = A8.update(g_blocks, state.opt_state, p_blocks, opt.schedule,
                                         t.adam_beta1, t.adam_beta2, t.adam_epsilon,
                                         t.weight_decay)
    p_state = {}
    for n in names:
        lp = plan.leaves[n]
        new = p_blocks[n].float() + updates[n].float()
        if t.param_dtype == "bfloat16":
            new = ema_lib.stochastic_round_bf16(
                new, plan.to_blocks(lp, draws["apply_bits"][n].to(new.device)))
        full = plan.from_blocks(lp, new.to(params[n].dtype))
        params[n].copy_(plan.param_local(lp, full))
        p_state[n] = plan.state_local(lp, full)
    return p_state


@contextlib.contextmanager
def full_parameters(state: TrainState):
    """Within the block, a ZeRO-3 state's module holds its whole (TP-local)
    parameters and runs without ZeRO-3's block call (the sampling eval's
    serving path); its shards come back after.  A no-op otherwise."""
    plan = state.plan
    if plan is None or not plan.zero3:
        yield state.module
        return
    module = state.module
    shards = {}
    with torch.no_grad():
        for n, p in module.named_parameters():
            lp = plan.leaves[n]
            if lp.data is not None:
                shards[n] = p.data
                p.data = lp.data.gather(p.data)
    call, module.model.block_call = module.model.block_call, None
    try:
        yield module
    finally:
        module.model.block_call = call
        for n, p in module.named_parameters():
            if n in shards:
                p.data = shards[n]


@torch.no_grad()
def gather_train_state(state: TrainState, to_host: bool = True) -> dict:
    """A sharded state's full leaves (collective: every rank calls it),
    leaf by leaf: {"params", "shadow", "opt_state"} in the one-device
    layout, on the host when ``to_host`` (only rank 0 keeps them; the
    others get None)."""
    from vla_touch_tpu_torch.parallel import launch

    plan = state.plan
    keep = launch.process_index() == 0

    def out(t):
        if not keep:
            return None
        return t.detach().to("cpu", copy=True) if to_host else t.detach()

    params = dict(state.module.named_parameters())
    res = {"params": {}, "shadow": {}}
    for n, lp in plan.leaves.items():
        res["params"][n] = out(plan.param_full(lp, params[n]))
        res["shadow"][n] = out(plan.state_full(lp, state.ema.shadow[n]))
    st = state.opt_state
    if isinstance(st, A8.Adam8bitState):
        full = A8.Adam8bitState(count=st.count, m_q={}, m_s={}, v_q={}, v_s={})
        for n, lp in plan.leaves.items():
            nb, _ = plan.n_blocks(lp)
            for k in ("m_q", "m_s", "v_q", "v_s"):
                getattr(full, k)[n] = out(plan.gather_blocks(getattr(st, k)[n], nb))
    else:
        from vla_touch_tpu_torch.train.optim import AdamWState

        full = AdamWState(count=st.count, mu={}, nu={})
        for n, lp in plan.leaves.items():
            full.mu[n] = out(plan.state_full(lp, st.mu[n]))
            full.nu[n] = out(plan.state_full(lp, st.nu[n]))
    res["opt_state"] = full
    return res if keep else None
