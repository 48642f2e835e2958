"""Logical-axis -> physical-mesh sharding rules, on a ``torch`` ``DeviceMesh``.

Torch twin of ``repro.sharding.rules``.  Production meshes
(``launch.mesh``): ``(data=16, model=16)`` single-pod, ``(pod=2, data=16,
model=16)`` multi-pod.  The logical rules are the JAX package's, verbatim:

* ``batch`` / ``capacity`` / ``kv_seq`` -> all data-parallel axes (``pod`` + ``data``);
* ``heads`` / ``kv_heads`` / ``qkv`` / ``mlp`` / ``vocab`` / ``expert`` /
  ``ssm_inner`` / ``cache_seq`` / ``embed_tp`` -> ``model``;
* ``embed`` -> ``data`` when FSDP is on; ``seq`` -> data axes when sequence
  sharding is on.

Every rule falls back to replication when the dimension does not divide
the mesh-axis extent.  A spec is a tuple with JAX's ``PartitionSpec``
entries (a mesh-axis name, a tuple of names, or None per dim, trailing
Nones dropped); ``placements`` turns it into DTensor placements, one per
mesh dim: ``Shard(i)`` where the mesh axis shards tensor dim i (a dim over
``("pod", "data")`` is ``Shard(i)`` on both, pod-major, as JAX lays it
out), ``Replicate()`` elsewhere.  ``constrain`` is JAX's
``with_sharding_constraint``: a DTensor is redistributed, a plain tensor
passes unchanged, so ``rules=None`` and a one-device mesh change nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]  # per dim: None, a mesh-axis name, or a tuple of names


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices (JAX's ``AbstractMesh``): specs and extents only."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@dataclass(frozen=True)
class Rules:
    mesh: Any  # a DeviceMesh, or an AbstractMesh (specs only)
    mapping: Dict[str, Tuple[str, ...]]
    axis_sizes: Dict[str, int]

    def spec(self, shape: Sequence[int], dims: Sequence[Optional[str]]) -> Spec:
        """The PartitionSpec entries for ``shape`` with logical ``dims`` labels."""
        assert len(shape) == len(dims), f"{shape} vs {dims}"
        used: set = set()
        out: List[Any] = []
        for size, dim in zip(shape, dims):
            axes = self.mapping.get(dim or "", ())
            axes = tuple(a for a in axes if a not in used)
            extent = math.prod(self.axis_sizes[a] for a in axes) if axes else 1
            if axes and size % extent == 0 and size >= extent:
                out.append(axes if len(axes) > 1 else axes[0])
                used.update(axes)
            else:
                out.append(None)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements_of(self, spec: Spec) -> Tuple[Any, ...]:
        """DTensor placements, one per mesh dim, of a spec."""
        from torch.distributed.tensor import Replicate, Shard

        where: Dict[str, int] = {}
        for i, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    where[a] = i
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in self.mesh.mesh_dim_names)

    def placements(self, shape: Sequence[int], dims: Sequence[Optional[str]]) -> Tuple[Any, ...]:
        return self.placements_of(self.spec(shape, dims))

    def sharding(self, shape: Sequence[int], dims: Sequence[Optional[str]]):
        """``(mesh, placements)``: the counterpart of a ``NamedSharding``."""
        return self.mesh, self.placements(shape, dims)

    @property
    def live(self) -> bool:
        """True where tensors are placed on the mesh: a DeviceMesh of more than one device."""
        return not isinstance(self.mesh, AbstractMesh) and self.mesh.size() > 1

    def constrain(self, x: torch.Tensor, dims: Sequence[Optional[str]]) -> torch.Tensor:
        if not is_dtensor(x):
            return x
        return x.redistribute(self.mesh, self.placements(x.shape, dims))

    def distribute(self, x: torch.Tensor, dims: Sequence[Optional[str]]) -> torch.Tensor:
        """A plain global tensor, equal on every rank, as a DTensor placed by ``dims``.

        Each rank keeps its own block (no communication).  Where the rules are
        not live the tensor passes unchanged."""
        from torch.distributed.tensor import DTensor

        if not self.live or is_dtensor(x):
            return x
        placements = self.placements(x.shape, dims)
        return DTensor.from_local(local_block(x, self.mesh, placements), self.mesh, placements,
                                  run_check=False, shape=x.shape, stride=x.stride())

    # ---- local regions ------------------------------------------------------
    # A region is code that runs on each rank's own block of the work, as JAX's
    # shard_map does: ``enter`` and ``param`` hand it local tensors, ``leave``
    # makes its result a DTensor again.  Its work is either split across the
    # model axis (each model rank computes a part: heads, columns, experts or
    # vocabulary rows; the parts are summed on leaving) or repeated on every
    # model rank.  The gradients that flow back are placed to match: summed
    # over the model axis for a split region, kept as they are for a repeated
    # one, and summed over the data axes for parameters where the batch is
    # sharded.

    @property
    def model_dim(self) -> int:
        return self.mesh.mesh_dim_names.index("model")

    @property
    def data_dims(self) -> Tuple[int, ...]:
        return tuple(self.mesh.mesh_dim_names.index(a) for a in self.data_axes)

    @property
    def model_rank(self) -> int:
        return self.mesh.get_local_rank("model") if self.live else 0

    @property
    def model_size(self) -> int:
        return self.axis_sizes["model"]

    def batch_sharded(self, x: torch.Tensor) -> bool:
        """True where the DTensor ``x`` is sharded on its dim 0 over the data axes."""
        from torch.distributed.tensor import Shard

        return is_dtensor(x) and all(x.placements[d] == Shard(0) for d in self.data_dims)

    def enter(self, x: torch.Tensor, dims: Sequence[Optional[str]], split: bool = False):
        """x's local block, laid out by ``dims``, for a region (see above)."""
        from torch.distributed.tensor import Partial, Replicate

        if not is_dtensor(x):
            return x
        placements = self.placements(x.shape, dims)
        grad = [Partial() if split and i == self.model_dim and isinstance(p, Replicate) else p
                for i, p in enumerate(placements)]
        return x.redistribute(self.mesh, placements).to_local(grad_placements=grad)

    def leave(self, y: torch.Tensor, like: torch.Tensor, split: bool = False):
        """A region's local result ``y`` as a DTensor laid out as the DTensor ``like``
        (same batch layout, replicated on the model axis); ``split``: the model ranks'
        results are partial sums, reduced here."""
        from torch.distributed.tensor import DTensor, Partial

        if not is_dtensor(like):
            return y
        placements = list(like.placements)
        if not split:
            return DTensor.from_local(y, self.mesh, placements, run_check=False)
        placements[self.model_dim] = Partial()
        out = DTensor.from_local(y, self.mesh, placements, run_check=False)
        return out.redistribute(self.mesh, like.placements)

    def batch_placements(self, data_sharded: bool, partial: bool = False) -> List[Any]:
        """Placements of a region's local tensor: dim 0 on the data axes where the batch
        is sharded, the model axis replicated (or partial sums)."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        out: List[Any] = [Replicate()] * len(self.mesh.mesh_dim_names)
        for d in self.data_dims:
            out[d] = Shard(0) if data_sharded else Replicate()
        if partial:
            out[self.model_dim] = Partial()
        return out

    def sum_model(self, t: torch.Tensor, data_sharded: bool) -> torch.Tensor:
        """The sum over the model axis of the ranks' local partials ``t`` (differentiable:
        what follows must be repeated on every model rank)."""
        from torch.distributed.tensor import DTensor

        if not self.live:
            return t
        part = DTensor.from_local(t, self.mesh, self.batch_placements(data_sharded, True),
                                  run_check=False)
        return part.redistribute(self.mesh, self.batch_placements(data_sharded)).to_local()

    def sum_data(self, t: torch.Tensor, data_sharded: bool) -> torch.Tensor:
        """The sum over the data axes of each data rank's ``t`` (a differentiable plain
        tensor, equal on every rank) where the batch is sharded; else ``t``."""
        from torch.distributed.tensor import DTensor, Partial, Replicate

        if not (self.live and data_sharded):
            return t
        full = [Replicate()] * len(self.mesh.mesh_dim_names)
        part = [Partial() if d in self.data_dims else p for d, p in enumerate(full)]
        t = DTensor.from_local(t, self.mesh, part, run_check=False)
        return t.redistribute(self.mesh, full).to_local()

    def sum_all(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over every rank of the mesh of the ranks' ``t`` (differentiable; what
        follows must be repeated on every rank)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate

        if not self.live:
            return t
        n = len(self.mesh.mesh_dim_names)
        t = DTensor.from_local(t, self.mesh, [Partial()] * n, run_check=False)
        return t.redistribute(self.mesh, [Replicate()] * n).to_local()

    @torch.no_grad()
    def gather(self, t: torch.Tensor, dim: int, mesh_dims: Sequence[int]) -> torch.Tensor:
        """The ranks' blocks of ``t`` along ``dim`` joined over ``mesh_dims`` (outer first),
        with torch.distributed's own all-gather: gloo's functional all-gather of CUDA
        tensors, which a DTensor redistribution issues, fails in the torch 2.11 seen on
        the card.  Not differentiable."""
        import torch.distributed as dist

        for d in reversed(sorted(mesh_dims)):
            n = self.mesh.size(d)
            out = t.new_empty((n * t.shape[0], *t.shape[1:]))
            dist.all_gather_into_tensor(out, t.contiguous(), group=self.mesh.get_group(d))
            t = out.view(n, *t.shape).movedim(0, dim).flatten(dim, dim + 1)
        return t

    def gather_model(self, t: torch.Tensor) -> torch.Tensor:
        """The model ranks' column blocks of the activation ``t`` joined (``gather`` of its
        last dim over the model axis), for work repeated alike on every model rank that ends
        in ``model_columns``.  Its backward, through ``_Gathered`` with nothing summed, hands
        each rank its own block of the whole's gradient, which that work gives every rank
        alike."""
        if torch.is_grad_enabled() and t.requires_grad:
            return _Gathered.apply(t, self, t.dim() - 1, (self.model_dim,), ())
        return self.gather(t, t.dim() - 1, (self.model_dim,))

    def model_columns(self, t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """The rank's columns [lo, hi) of ``t``, which every model rank holds alike (after
        ``gather_model``); the backward joins the ranks' gradients of their columns over the
        model axis, so that each rank's backward of ``t`` sees the whole gradient."""
        if torch.is_grad_enabled() and t.requires_grad:
            return _Columns.apply(t, self, lo, hi)
        return t[..., lo:hi]

    def full(self, x: torch.Tensor) -> torch.Tensor:
        """A DTensor gathered whole on every rank (``gather`` over each sharded dim; partial
        sums reduced first); a plain tensor as it is."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        if not is_dtensor(x):
            return x
        if any(isinstance(p, Partial) for p in x.placements):
            x = x.redistribute(self.mesh, [Replicate() if isinstance(p, Partial) else p
                                           for p in x.placements])
        t = x.to_local()
        for dim in sorted({p.dim for p in x.placements if isinstance(p, Shard)}):
            t = self.gather(t, dim, [d for d, p in enumerate(x.placements) if p == Shard(dim)])
        return t

    def param(self, w: torch.Tensor, *, split: bool, data_sharded: bool,
              keep_dim: Optional[int] = None) -> torch.Tensor:
        """The local copy a region reads of the parameter ``w``: gathered whole, except
        that where ``w`` is sharded on the model axis along ``keep_dim``, the rank's own
        block is kept (the region's split then follows it).  ``data_sharded``: the
        region's batch is sharded over the data axes."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        if not is_dtensor(w):
            return w
        if not torch.is_grad_enabled():  # serving: torch.distributed's own all-gather (``gather``)
            t = w.to_local()
            for dim in sorted({p.dim for p in w.placements if isinstance(p, Shard)}):
                over = [i for i, p in enumerate(w.placements) if p == Shard(dim)
                        and not (i == self.model_dim and dim == keep_dim)]
                if over:
                    t = self.gather(t, dim, over)
            return t
        # training: the local block, then the gathers through ``gather`` (``_Gathered``),
        # whose backward hands each rank its block of the gradient
        gathered, grad = {}, []
        for i, p in enumerate(w.placements):
            summed = data_sharded if i in self.data_dims else split
            if isinstance(p, Shard):
                if not (i == self.model_dim and p.dim == keep_dim):
                    gathered.setdefault(p.dim, []).append((i, summed))
                grad.append(p)
            else:
                grad.append(Partial() if summed else Replicate())
        t = w.to_local(grad_placements=grad)
        for dim, over in sorted(gathered.items()):
            t = _Gathered.apply(t, self, dim, tuple(i for i, _ in over),
                                tuple(i for i, summed in over if summed))
        return t

    def kept_range(self, w: torch.Tensor, dim: int) -> Optional[Tuple[int, int]]:
        """[lo, hi) of ``w``'s dim ``dim`` that this rank holds where ``w`` is sharded
        along it on the model axis (what ``param(..., keep_dim=dim)`` keeps), else None."""
        from torch.distributed.tensor import Shard

        if not is_dtensor(w) or w.placements[self.model_dim] != Shard(dim):
            return None
        n = w.shape[dim] // self.model_size
        return self.model_rank * n, (self.model_rank + 1) * n

    def zeros(self, shape: Sequence[int], dtype: torch.dtype, device, spec: Spec):
        """A DTensor of zeros placed by ``spec``; each rank allocates its own block."""
        from torch.distributed.tensor import DTensor

        placements = self.placements_of(spec)
        local, _ = block_of(shape, self.mesh, placements)
        return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), self.mesh,
                                  placements, run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    def extent(self, dim: str) -> int:
        """Total mesh extent the logical ``dim`` maps onto (1 if unmapped)."""
        axes = self.mapping.get(dim, ())
        return math.prod(self.axis_sizes[a] for a in axes) if axes else 1

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return self.mapping["batch"]

    @property
    def data_extent(self) -> int:
        return math.prod(self.axis_sizes[a] for a in self.data_axes)


class _Gathered(torch.autograd.Function):
    """``Rules.gather`` of a parameter's or an activation's block with a gradient: the
    backward sums the incoming gradient over the mesh dims ``summed`` (where the ranks'
    gradients are partial sums; in f32 where it is narrower) and hands each rank its own
    block.  A DTensor redistribution would all-gather with gloo's functional collective,
    which fails on CUDA tensors."""

    @staticmethod
    def forward(ctx, t, rules, dim, mesh_dims, summed):
        ctx.rules, ctx.dim, ctx.mesh_dims, ctx.summed = rules, dim, mesh_dims, summed
        return rules.gather(t, dim, mesh_dims)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        mesh = ctx.rules.mesh
        coord = mesh.get_coordinate()
        dtype = g.dtype
        for d in sorted(ctx.mesh_dims):  # outer first, as ``gather`` lays the blocks out
            if d in ctx.summed:
                g = g.to(torch.promote_types(dtype, torch.float32), copy=True).contiguous()
                dist.all_reduce(g, group=mesh.get_group(d))
            g = g.unflatten(ctx.dim, (mesh.size(d), -1)).select(ctx.dim, coord[d])
        return g.to(dtype).contiguous(), None, None, None, None


class _Columns(torch.autograd.Function):
    """``Rules.model_columns``: the forward slices the rank's columns of a tensor the model
    ranks hold alike; the backward gathers the ranks' column gradients whole (c10d)."""

    @staticmethod
    def forward(ctx, t, rules, lo, hi):
        ctx.rules = rules
        return t[..., lo:hi]

    @staticmethod
    def backward(ctx, g):
        rules = ctx.rules
        return rules.gather(g.contiguous(), g.dim() - 1, (rules.model_dim,)), None, None, None


def block_of(shape: Sequence[int], mesh, placements) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of this rank's block of a tensor of ``shape`` under
    ``placements`` (even shards, as the specs guarantee; several mesh dims on one
    tensor dim split it in mesh-dim order, outer first)."""
    from torch.distributed.tensor import Shard

    local, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(mdim)
            offset[p.dim] += coord[mdim] * local[p.dim]
    return tuple(local), tuple(offset)


def local_block(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``placements`` (even shards)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(mdim)
            x = x.narrow(p.dim, coord[mdim] * (x.shape[p.dim] // n), x.shape[p.dim] // n)
    return x.contiguous()


def make_rules(mesh, fsdp: bool = False, seq_shard: bool = False) -> Rules:
    axes = tuple(mesh.mesh_dim_names)
    data_axes: Tuple[str, ...] = ("pod", "data") if "pod" in axes else ("data",)
    mapping: Dict[str, Tuple[str, ...]] = {
        "batch": data_axes,
        "capacity": data_axes,
        "kv_seq": data_axes,
        "seq": data_axes if seq_shard else (),
        "heads": ("model",),
        "kv_heads": ("model",),
        # decode KV caches: the sequence dim shards on the model axis (batch on data)
        "cache_seq": ("model",),
        "qkv": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
        "ssm_inner": ("model",),
        "embed": ("data",) if fsdp else (),
        "embed_tp": ("model",),  # activations' d_model inside TP regions
        "layers": (),
        "head_dim": (),
        "ssm_state": (),
        "": (),
    }
    return Rules(mesh=mesh, mapping=mapping, axis_sizes=dict(zip(axes, tuple(mesh.shape))))


def single_device_rules(device: torch.device | str = "cuda") -> Rules:
    """Rules over the trivial 1 x 1 mesh on ``device`` (tests / smoke runs)."""
    from repro_torch.launch.mesh import make_host_mesh

    return make_rules(make_host_mesh(device))
