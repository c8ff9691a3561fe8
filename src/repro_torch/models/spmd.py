"""The few model steps whose DTensor form needs help, so that the same
model code runs on plain tensors and, with parameters placed on a mesh
(``repro_torch.parallel.sharding``), on DTensors.

DTensor propagates most ops by itself.  Seven do not go through as
written, and here each is computed on the local shards explicitly:

* the residual stream, which each block would leave in whatever layout its
  last op chose, is kept in the tokens' layout: the embedding's output
  (a lookup in a vocabulary-sharded table, with sums that may be reduced
  once only) is brought to it, and each block's output to the stream's
  before the add (:func:`match_layout`);
* a head split of a projection whose head count the mesh does not divide
  (:func:`split_heads`, :func:`merge_heads`), and the grouped-query
  attention itself (:func:`local_heads`);
* Mamba-2's chunk scan, which runs on each device's heads
  (:func:`scan_heads`);
* a depthwise convolution over sharded channels (:func:`depthwise_conv1d`),
  and zero padding, which DTensor's own rule may place wrongly on a mesh of
  more than one dim (:func:`pad`);
* the loss's ``log_softmax`` over vocabulary-parallel logits, which
  DTensor would gather whole (:func:`log_softmax`), and its pick of the
  labels' entries (:func:`pick`).

On plain tensors every function is the plain operation.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication


def on_mesh(mesh):
    """The context a step on ``mesh``'s DTensors runs in: plain tensors the
    model makes (positions, masks, constants) count as replicated.  No mesh:
    nothing."""
    return contextlib.nullcontext() if mesh is None else implicit_replication()


def full(t):
    """A DTensor's whole value on every rank; anything else as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def trips(n: int, like: torch.Tensor):
    """``range(n)`` for a loop whose trips all have the same shapes.  While
    ``core.roofline.count_step`` counts a step on ``meta`` tensors, one trip
    whose counts weigh ``n`` (the reference scales a loop body by its trip
    count): the loop then runs once, and its values are shapes only.  Not
    where autograd records the loop: its backward replays the trips that
    ran, unweighted."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    counter = next((m for m in _get_current_dispatch_mode_stack() if hasattr(m, "weigh")), None)
    if counter is None or not like.is_meta or n <= 1 or torch.is_grad_enabled():
        return range(n)
    return counter.weigh(n)


def _sharding(t: DTensor, dim: int) -> list[int]:
    """The mesh dims that shard tensor dim ``dim`` of ``t``."""
    dim %= t.ndim
    return [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim]


def _replace(t: DTensor, mesh_dims, placement) -> list:
    return [placement if i in mesh_dims else p for i, p in enumerate(t.placements)]


def _ways(t: DTensor, mesh_dims) -> int:
    return math.prod(t.device_mesh.size(i) for i in mesh_dims)


def _coordinate(t: DTensor, mesh_dims) -> int:
    """This rank's index among the ``mesh_dims`` shards (major first)."""
    coord = t.device_mesh.get_coordinate()
    r = 0
    for i in mesh_dims:
        r = r * t.device_mesh.size(i) + coord[i]
    return r


class _LayoutGrad(torch.autograd.Function):
    """Identity whose gradient is brought to the value's layout: pending
    sums in the gradient are reduced here, at the layer boundary, and never
    meet the lookup's masked sums."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def match_layout(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` laid out as ``like`` (pending sums reduced), and so is its
    gradient: the residual stream [B, T, d] as the tokens [B, T] are
    (batch, and sequence if it is, sharded), and each block's output as the
    stream it is added to, so that every layer starts from one layout (the
    row-parallel products' all-reduce).  Plain tensors pass through."""
    if not isinstance(x, DTensor):
        return x
    placements = like.placements if isinstance(like, DTensor) else [Replicate()] * x.device_mesh.ndim
    return _LayoutGrad.apply(x.redistribute(x.device_mesh, placements))


def _reshape_local(t: DTensor, shape) -> DTensor:
    """Reshape a DTensor sharded at most on dim 0, which the reshape keeps,
    shard by shard (DTensor's own rule would look at the global split)."""
    local = t.to_local()
    out = local.reshape(local.shape[0], *shape[1:])
    return DTensor.from_local(out, t.device_mesh, t.placements, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous(shape))


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def pick(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logp[..., labels]``: [B, T, V], [B, T] → [B, T].  On
    vocabulary-parallel DTensor logits each shard keeps its own labels'
    entries and the sums are reduced (a gather's backward would gather the
    logits' gradient whole)."""
    if not _vocab_split(logp):
        return torch.gather(logp, -1, labels[..., None])[..., 0]
    vocab = torch.arange(logp.shape[-1], device=logp.device)
    return _LayoutGrad.apply(settle(torch.where(vocab == labels[..., None], logp, 0.0).sum(dim=-1)))


def _vocab_split(x: torch.Tensor) -> bool:
    """Whether ``x``'s last dim is split over more than one device."""
    return isinstance(x, DTensor) and _ways(x, _sharding(x, -1)) > 1


def settle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums reduced, those mesh dims replicated."""
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``log_softmax`` over the last dim.  For a DTensor split on that dim
    (vocabulary-parallel logits) it is taken from the shards' maxima and
    sums, so the logits are never gathered."""
    if not _vocab_split(x):
        return torch.log_softmax(x, dim=-1)
    m = settle(x.detach().amax(dim=-1, keepdim=True))
    lse = m + torch.log(settle(torch.exp(x - m).sum(dim=-1, keepdim=True)))
    return x - _LayoutGrad.apply(lse)


def split_heads(t: torch.Tensor, n: int, hd: int, *, uneven: bool = False) -> torch.Tensor:
    """[B, T, n·hd] → [B, T, n, hd].  A DTensor sharded on the last dim
    keeps whole heads on each shard: when the shards do not divide ``n``
    the projection is gathered first and then, with ``uneven`` (the query
    heads), split again by heads as ``torch.chunk`` splits them (no
    communication), else left replicated."""
    B, T = t.shape[:2]
    if not isinstance(t, DTensor):
        return t.reshape(B, T, n, hd)
    dims = _sharding(t, -1)
    if n % _ways(t, dims) == 0:
        t = t.reshape(B, T, n, hd)
        # a single head on a mesh dim of size 1 may come out split on hd
        return t.redistribute(t.device_mesh, _replace(t, _sharding(t, 3), Replicate()))
    t = _reshape_local(t.redistribute(t.device_mesh, _replace(t, dims, Replicate())),
                       (B, T, n, hd))
    if uneven and n >= _ways(t, dims):
        t = t.redistribute(t.device_mesh, _replace(t, dims, Shard(2)))
    return t


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """[B, T, n, hd] → [B, T, n·hd]; heads split unevenly are gathered
    first."""
    B, T, n, hd = o.shape
    if isinstance(o, DTensor):
        dims = _sharding(o, 2)
        if n % _ways(o, dims):
            o = o.redistribute(o.device_mesh, _replace(o, dims, Replicate()))
            return _reshape_local(o, (B, T, n * hd))
    return o.reshape(B, T, n * hd)


def local_heads(q, k, v, cache: dict | None):
    """Grouped-query attention on the local shards.  For DTensors (from
    :func:`split_heads`) → (q, k, v, cache, expand, wrap): the local
    shards, the cache's local tensors (writes land in the DTensors),
    ``expand``, which maps local key/value heads [..., K_local, hd] to the
    ones the local query heads attend to (one per query head when those do
    not form whole groups), and ``wrap``, which makes the local output
    [B, T, H_local, hd] a DTensor placed as ``q``.  Plain tensors pass
    through."""
    if not isinstance(q, DTensor):
        return q, k, v, cache, lambda kv: kv, lambda o: o
    H, K = q.shape[2], k.shape[2]
    G = H // K
    qdims, kdims = _sharding(q, 2), _sharding(k, 2)
    if not (_sharding(q, 0) == _sharding(k, 0) == _sharding(v, 0)) or any(
            p.is_partial() or (isinstance(p, Shard) and p.dim in (1, 3))
            for t in (q, k, v) for p in t.placements):
        raise ValueError(f"attention needs batch- or head-sharded q, k, v alike: {q.placements}, "
                         f"{k.placements}, {v.placements}")
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    h0 = _coordinate(q, qdims) * -(-H // _ways(q, qdims)) if qdims else 0
    k0 = _coordinate(k, kdims) * (K // _ways(k, kdims)) if kdims else 0
    need = [(h0 + h) // G - k0 for h in range(ql.shape[2])]
    if need == [i // G for i in range(kl.shape[2] * G)]:
        expand = lambda kv: kv  # noqa: E731  whole groups
    else:
        # made on the device (a copy from the host could not be captured)
        idx = torch.arange(ql.shape[2], device=ql.device).add_(h0).div_(
            G, rounding_mode="floor").sub_(k0)
        expand = lambda kv: kv.index_select(2, idx)  # noqa: E731
    local_cache = None if cache is None else {
        name: t.to_local() if isinstance(t, DTensor) else t for name, t in cache.items()}

    def wrap(o):
        return DTensor.from_local(o.contiguous(), q.device_mesh, q.placements, run_check=False,
                                  shape=q.shape, stride=q.stride())

    return ql, kl, vl, local_cache, expand, wrap


def scan_heads(scan, xh, bc, cc, dt, la, h):
    """``scan(xh, bc, cc, dt, la, h) → (y, h)``, the SSD chunk scan, on each
    device's heads.  For DTensors: the batch as ``xh``'s, the heads (xh
    [B,T,nh,hp], dt and la [B,T,nh], h [B,nh,hp,ds]) split over every other
    mesh dim whose size divides them, B and C [B,T,ds] whole; heads are
    independent in the scan, so each device scans its own."""
    if not isinstance(xh, DTensor):
        return scan(xh, bc, cc, dt, la, h)
    mesh = xh.device_mesh
    batch = _sharding(xh, 0)
    heads, ways = [], 1
    for i in range(mesh.ndim):
        if i not in batch and xh.shape[2] % (ways * mesh.size(i)) == 0:
            heads.append(i)
            ways *= mesh.size(i)

    def layout(head_dim):
        return [Shard(0) if i in batch else Shard(head_dim) if head_dim and i in heads
                else Replicate() for i in range(mesh.ndim)]

    def local(t, head_dim):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, layout(head_dim)).to_local()

    y, h_out = scan(local(xh, 2), local(bc, None), local(cc, None), local(dt, 2), local(la, 2),
                    local(h, 1))
    B, T, nh, hp = xh.shape
    return tuple(DTensor.from_local(t, mesh, layout(hd), run_check=False, shape=torch.Size(shape),
                                    stride=_contiguous(shape))
                 for t, hd, shape in ((y, 2, (B, T, nh, hp)), (h_out, 1, (B, nh, hp, bc.shape[-1]))))


def pad(x: torch.Tensor, widths: tuple) -> torch.Tensor:
    """``F.pad(x, widths)`` with zeros.  A DTensor is padded shard by shard
    (its padded dims gathered first if they are split), not through
    DTensor's own rule for the op."""
    if not isinstance(x, DTensor):
        return F.pad(x, widths)
    dims = [x.ndim - 1 - i for i in range(len(widths) // 2)]
    split = [i for d in dims for i in _sharding(x, d)]
    if split:
        x = x.redistribute(x.device_mesh, _replace(x, split, Replicate()))
    shape = list(x.shape)
    for i, d in enumerate(dims):
        shape[d] += widths[2 * i] + widths[2 * i + 1]
    return DTensor.from_local(F.pad(x.to_local(), widths), x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape), stride=_contiguous(shape))


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, *, groups: int) -> torch.Tensor:
    """``F.conv1d(x, w, groups=groups)`` with x [B, C, T'] and w [C, 1, W].
    A DTensor ``x`` sharded on its channels convolves each shard with its
    own channels' taps."""
    if not isinstance(x, DTensor):
        return F.conv1d(x, w, groups=groups)
    wd = w if isinstance(w, DTensor) else DTensor.from_local(
        w, x.device_mesh, [Replicate()] * x.device_mesh.ndim, run_check=False)
    dims = _sharding(x, 1)
    wd = wd.redistribute(x.device_mesh, [Shard(0) if i in dims else Replicate()
                                         for i in range(x.device_mesh.ndim)])
    xl, wl = x.to_local(), wd.to_local()
    out = F.conv1d(xl, wl, groups=xl.shape[1])
    B, _, _ = x.shape
    return DTensor.from_local(out, x.device_mesh, x.placements, run_check=False,
                              shape=(B, x.shape[1], out.shape[2]),
                              stride=(x.shape[1] * out.shape[2], out.shape[2], 1))
