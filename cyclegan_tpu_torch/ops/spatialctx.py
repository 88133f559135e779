"""H-axis spatial sharding with explicit halos (cyclegan_tpu/ops/spatialctx.py).

Each rank of a spatial process group holds one horizontal strip of every
image (H = axis 1 in NHWC and NHCW alike), and the ops that need rows of
the neighbouring strips take them here, explicitly:

- ``halo_exchange_h``: the ``above`` rows before the strip come from the
  previous rank, the ``below`` rows after it from the next; the ranks at
  the image's top and bottom receive zeros, which is 'SAME' zero padding
  at the global edges. Its backward returns each halo row's gradient to
  the rank that produced the row.
- ``halo_exchange_h_reflect``: the same exchange, with the first rank's
  top halo and the last rank's bottom halo replaced by reflected rows of
  their own strip (edge not repeated, ``ops/pad.py``).
- ``gather_h`` / ``slice_local_h``: the whole images on every rank (the
  augmentation's resize needs them) and a rank's strip back out of them.
- ``all_reduce_sum``: a differentiable sum over a group, for the norms'
  statistics (``ops/norm.py``); its backward sums the gradients the same
  way.

The scope is ambient, as ``ops/layout.py``'s: ``spatial(group, n_shards,
index)`` holds on the thread that enters it, and ``ops/conv.py``,
``ops/norm.py`` and ``ops/pool.py`` read it. The kernels are unchanged: a
stride-1 SAME conv on the halo-extended strip gives the strip's rows in
its interior, so K1 and K5 run on it as they are.

The three collectives are autograd Functions with ``setup_context`` and a
``vmap`` rule, so ``torch.func.vmap`` (the paired step's twin networks)
maps over them: the mapped dimension is folded into the batch and each
collective runs once on the stacked tensor (``_folded``).

Every collective is an ``all_reduce`` (the gloo backend takes CUDA tensors
only in ``all_reduce`` and ``broadcast``, and two ranks that share one card
must use gloo): an exchange writes this rank's rows into its slot of a
zero buffer with a slot per rank, sums the buffer over the group, and
reads the neighbours' slots. Every rank makes the same calls with buffers
of the same size, the edge ranks included, so the collectives of a
backward come in the same order on every rank.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as dist


class _State(threading.local):
    group = None     # the spatial process group, None outside a scope
    n = 1            # its size
    index = 0        # this rank's strip


_STATE = _State()


def is_active() -> bool:
    return _STATE.group is not None


def n_shards() -> int:
    return _STATE.n


def group():
    return _STATE.group


def current() -> Tuple[object, int, int]:
    """(group, n_shards, index) of the scope, for ``scope``: a function
    run after its caller's scope closed (a rematerialized forward)
    re-enters it."""
    return _STATE.group, _STATE.n, _STATE.index


def scope(state: Tuple[object, int, int]):
    """Re-enter a scope that ``current`` returned (no-op for None)."""
    grp, n, idx = state
    return spatial(grp, n, idx, enabled=grp is not None)


@contextlib.contextmanager
def spatial(group, n_shards: int, index: Optional[int] = None,
            enabled: bool = True):
    """Scope H-sharded execution over ``group`` (``n_shards`` ranks; this
    one holds strip ``index``, its rank in the group by default). A no-op
    with ``enabled=False`` or one shard."""
    prev = (_STATE.group, _STATE.n, _STATE.index)
    if enabled and int(n_shards) > 1:
        if index is None:
            index = dist.get_rank(group)
        _STATE.group, _STATE.n, _STATE.index = group, int(n_shards), \
            int(index)
    try:
        yield
    finally:
        _STATE.group, _STATE.n, _STATE.index = prev


def _summed_slots(part: torch.Tensor, group, n: int, idx: int
                  ) -> torch.Tensor:
    """A zero buffer [n, *part.shape] with ``part`` in slot ``idx``,
    summed over ``group``: every rank's part, on every rank."""
    buf = torch.zeros((n,) + tuple(part.shape), dtype=part.dtype,
                      device=part.device)
    buf[idx] = part
    dist.all_reduce(buf, group=group)
    return buf


def _folded(function, in_dims, x, *args):
    """The ``vmap`` rule of a collective Function whose first input is an
    activation with H at axis 1: the mapped dimension folded into the
    leading batch dimension (H stays at axis 1), the collective run once on
    the stacked tensor, the result viewed back. So every rank issues the
    same collectives, one per call, whatever it maps over."""
    x = x.movedim(in_dims[0], 0)
    members, batch = x.shape[:2]
    y = function.apply(x.reshape(members * batch, *x.shape[2:]), *args)
    return y.view(members, batch, *y.shape[1:]), 0


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        """Elementwise: one all-reduce of the stacked tensor as it is."""
        return _AllReduceSum.apply(x, group), in_dims[0]


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group`` (None: x itself), differentiable: the
    gradient of a sum every rank reads is the sum of their gradients."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(x, above, below, group, n, idx):
        h = x.shape[1]
        part = torch.cat([x[:, h - above:], x[:, :below]], dim=1)
        buf = _summed_slots(part, group, n, idx)
        top = (buf[idx - 1, :, :above] if idx > 0
               else torch.zeros_like(part[:, :above]))
        bot = (buf[idx + 1, :, above:] if idx < n - 1
               else torch.zeros_like(part[:, above:]))
        return torch.cat([top, x, bot], dim=1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, above, below, group, n, idx = inputs
        ctx.conf = (above, below, group, n, idx, x.shape[1])

    @staticmethod
    def backward(ctx, g):
        above, below, group, n, idx, h = ctx.conf
        part = torch.cat([g[:, :above], g[:, above + h:]], dim=1)
        buf = _summed_slots(part.contiguous(), group, n, idx)
        dx = g[:, above:above + h].clone()
        if idx < n - 1 and above:  # my last rows were the next top halo
            dx[:, h - above:] += buf[idx + 1, :, :above]
        if idx > 0 and below:      # my first rows, the previous bottom one
            dx[:, :below] += buf[idx - 1, :, above:]
        return dx, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, above, below, group, n, idx):
        return _folded(_HaloExchange, in_dims, x, above, below, group, n,
                       idx)


def halo_exchange_h(x: torch.Tensor, above: int, below: int) -> torch.Tensor:
    """Extend this rank's strip with ``above`` rows of the previous strip
    and ``below`` rows of the next (H = axis 1); the global edges receive
    zeros, which is 'SAME' zero padding at the image boundary."""
    assert is_active(), "no spatial context active"
    if above <= 0 and below <= 0:
        return x
    h = x.shape[1]
    if above > h or below > h:
        raise ValueError(
            f"conv halo ({above} above / {below} below rows) exceeds the "
            f"local H shard ({h} rows) — a halo can only come from the "
            f"adjacent shard (one exchange). Use fewer spatial "
            f"devices for this resolution/depth.")
    return _HaloExchange.apply(x, max(above, 0), max(below, 0),
                               _STATE.group, _STATE.n, _STATE.index)


def halo_exchange_h_reflect(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``halo_exchange_h(x, pad, pad)`` with the first rank's top halo and
    the last rank's bottom halo replaced by their own strip's reflected
    rows (edge not repeated). Requires ``pad < H_local``. Every rank builds
    the same graph (the choice is a ``torch.where`` on its index)."""
    assert is_active(), "no spatial context active"
    if pad <= 0:
        return x
    h = x.shape[1]
    if pad >= h:
        raise ValueError(
            f"reflect halo ({pad} rows) needs pad < local H ({h} rows): "
            f"the edge shards reflect their own rows (edge not repeated)."
            f" Use fewer spatial devices for this resolution/depth.")
    x_ext = halo_exchange_h(x, pad, pad)
    first = torch.tensor(_STATE.index == 0, device=x.device)
    last = torch.tensor(_STATE.index == _STATE.n - 1, device=x.device)
    top = torch.where(first, x[:, 1:pad + 1].flip(1), x_ext[:, :pad])
    bot = torch.where(last, x[:, h - pad - 1:h - 1].flip(1),
                      x_ext[:, pad + h:])
    return torch.cat([top, x, bot], dim=1)


class _GatherH(torch.autograd.Function):
    @staticmethod
    def forward(x, group, n, idx):
        buf = _summed_slots(x.contiguous(), group, n, idx)
        return buf.movedim(0, 1).reshape(x.shape[0], n * x.shape[1],
                                          *x.shape[2:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, group, n, idx = inputs
        ctx.conf = (group, n, idx, x.shape[1])

    @staticmethod
    def backward(ctx, g):
        group, n, idx, h = ctx.conf
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return g[:, idx * h:(idx + 1) * h], None, None, None

    @staticmethod
    def vmap(info, in_dims, x, group, n, idx):
        return _folded(_GatherH, in_dims, x, group, n, idx)


def gather_h(x: torch.Tensor) -> torch.Tensor:
    """Every rank's strip concatenated along H: the whole images."""
    assert is_active(), "no spatial context active"
    return _GatherH.apply(x, _STATE.group, _STATE.n, _STATE.index)


def slice_local_h(x_full: torch.Tensor) -> torch.Tensor:
    """This rank's H strip out of whole images."""
    assert is_active(), "no spatial context active"
    h_full = x_full.shape[1]
    assert h_full % _STATE.n == 0, (h_full, _STATE.n)
    h = h_full // _STATE.n
    return x_full[:, _STATE.index * h:(_STATE.index + 1) * h]
