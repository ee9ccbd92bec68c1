"""Device meshes for sharded batch solves, over the cards of a process and
the processes of a ``torch.distributed`` group.

Counterpart of the JAX package's ``parallel/mesh.py``.  Every instance of a
batched solve is independent, so a sharded solve is pure SPMD:

    batch of independent instances
        -> padded to a multiple of the mesh's slots (edge rows, ``pad_batch``)
        -> one block of rows a slot, each run through its family's kernel
           on the slot's device
        -> gathered back to the host (``fetch_global``) and trimmed.

No collective runs in the hot loop; the only cross-device traffic is the
final gather of per-instance results.

- :class:`Mesh` is an array of ``torch.device`` slots shaped like its axes.
  A slot may repeat a device: shards on one device then run one after the
  other, which is how a single card (or the CPU, in the tests) drives the
  split, as the JAX tests drive it over XLA's virtual CPU devices.
- A mesh knows which slots belong to this process.  A mesh built by
  :func:`multihost_mesh` spans the processes of the group: every process
  holds the same global host array, solves its own slots' rows, and gets
  the whole result back through an all-gather over the group (gloo on the
  CPU, NCCL between cards).
- The solvers launch every slot's kernel before they fetch any result, so
  shards on distinct cards run at the same time.
- Spans (``utils/observability``): ``psa.mesh.shard`` (the padding, the
  shared copies and every slot's rows), ``psa.wait`` (under a profiler,
  every slot's card), ``psa.mesh.gather`` (every output back, trimmed) and,
  inside it, ``psa.fetch`` for each block copied to the host.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.checks import resolve_device
from ..utils.observability import span, wait

BATCH_AXIS = "batch"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _local_slot(device) -> torch.device:
    """A slot this process drives: a CUDA slot names a card this process
    has (a bare ``cuda`` is the current card), else it raises; there is no
    fallback to the CPU."""
    d = torch.device(device)
    if d.type != "cuda":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh slot {d} needs a CUDA card, and none is available")
    index = torch.cuda.current_device() if d.index is None else d.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh slot {d}: this process has {torch.cuda.device_count()} "
                           "CUDA card(s)")
    return torch.device("cuda", index)


class Mesh:
    """An array of ``torch.device`` slots shaped like ``axis_names``.

    ``shape`` maps each axis to its size, in order; ``devices`` is the slot
    array; ``process_ids`` the rank of the process that drives each slot
    (this process for every slot unless :func:`multihost_mesh` built the
    mesh over a group).  ``axis_types`` is accepted for the JAX signature
    and must be None."""

    def __init__(self, devices, axis_names, axis_types=None):
        if axis_types is not None:
            raise ValueError("axis_types is not used by the port's meshes; pass None")
        self._setup(devices, axis_names, None)

    def _setup(self, devices, axis_names, process_ids) -> None:
        names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(names) or arr.size == 0:
            raise ValueError(f"devices of shape {arr.shape} do not fit the axes {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names must be distinct, got {names}")
        me = _rank()
        owners = (np.full(arr.shape, me, dtype=np.int64) if process_ids is None
                  else np.asarray(process_ids, dtype=np.int64).reshape(arr.shape))
        slots = [_local_slot(d) if r == me else torch.device(d)
                 for d, r in zip(arr.ravel(), owners.ravel())]
        self.devices = np.asarray(slots, dtype=object).reshape(arr.shape)
        self.axis_names = names
        self.process_ids = owners
        self.shape = collections.OrderedDict(zip(names, arr.shape))
        self._group = False

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        """Whether the mesh was built over a process group (a result then
        comes back through an all-gather over the group)."""
        return self._group

    def local_slots(self) -> list:
        """``[(flat slot index, device)]`` of the slots this process drives,
        in mesh order."""
        me = _rank()
        return [(i, d) for i, (d, r) in enumerate(zip(self.devices.ravel(),
                                                      self.process_ids.ravel())) if r == me]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.ravel()]})"


def check_mesh(mesh) -> Mesh:
    """``mesh`` if it is a port :class:`Mesh`; anything else raises."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh of the port, got {type(mesh)!r}")
    return mesh


def _cards() -> list:
    """This process's CUDA cards; none raises, as ``resolve_device`` does."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was given: the port runs on the CUDA "
            "card by default; pass device='cpu' for CPU slots")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_mesh(n_devices: Optional[int] = None, *, axis_name: str = BATCH_AXIS,
                 device=None) -> Optional[Mesh]:
    """A 1-D mesh over this process's CUDA cards (up to ``n_devices``), and
    None for one card, where the unsharded solve is already the whole card.

    ``device`` names one device to repeat instead: ``n_devices`` slots on it
    (``device='cpu'`` for CPU slots, ``'cuda:0'`` to split over one card); a
    bare ``'cuda'`` is the same as None.  None again for one slot."""
    d = None if device is None else torch.device(device)
    if d is None or (d.type == "cuda" and d.index is None):
        slots = _cards()
        if n_devices is not None:
            slots = slots[:max(int(n_devices), 0)]
    else:
        slots = [d] * (1 if n_devices is None else int(n_devices))
    if len(slots) <= 1:
        return None
    return Mesh(slots, (axis_name,))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a global array lies on a mesh: its leading axis split over the
    mesh axes in ``spec`` (the first the major one), and replicated along
    the others (an empty ``spec`` replicates it on every slot)."""

    mesh: Mesh
    spec: Tuple[str, ...]

    @property
    def is_fully_addressable(self) -> bool:
        return not self.mesh.spans_processes

    @property
    def n_blocks(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.spec], dtype=np.int64))

    def block_of(self, slot: int) -> int:
        """The block of rows the flat slot index ``slot`` holds."""
        where = np.unravel_index(slot, tuple(self.mesh.shape.values()))
        pos = dict(zip(self.mesh.axis_names, where))
        block = 0
        for a in self.spec:
            block = block * self.mesh.shape[a] + int(pos[a])
        return block


def batch_sharding(mesh: Mesh, *, axis_name=None) -> Sharding:
    """The sharding that splits the leading (batch) axis over the mesh.

    ``axis_name=None`` folds the batch over every mesh axis (both axes of a
    (dcn, batch) mesh); an axis name, or a tuple of them, splits it over
    just those and replicates it along the others."""
    check_mesh(mesh)
    if axis_name is None:
        axes = tuple(mesh.axis_names)
    else:
        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        missing = [a for a in axes if a not in mesh.axis_names]
        if missing:
            raise ValueError(f"axis_name {missing} not in mesh axes {tuple(mesh.axis_names)}")
    return Sharding(mesh, axes)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(check_mesh(mesh), ())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    auto_detect: bool = True,
    **kwargs,
) -> bool:
    """Join a ``torch.distributed`` group; True if it has more than one
    process, False for the single-process case.

    Safe to call unconditionally: a no-op when the group already exists,
    and False, doing nothing, when no coordinator is configured.  With no
    ``coordinator_address`` and ``auto_detect``, the ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` that ``torchrun`` sets stand
    in for JAX's cluster auto-detection.  The group rendezvous at
    ``tcp://<coordinator_address>``; its backend is ``nccl`` in a process
    that drives cards and ``gloo`` on the CPU, unless ``backend=`` is in
    ``kwargs`` (which go to ``init_process_group``).  Once a coordinator is
    configured, a failure raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None:
        if not (auto_detect and env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            return False
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env.get("WORLD_SIZE", 1)) if num_processes is None else num_processes
        process_id = int(env.get("RANK", 0)) if process_id is None else process_id
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator_address needs num_processes and process_id")
    backend = kwargs.pop("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id), **kwargs)
    return dist.get_world_size() > 1


def _slots_of(device) -> list:
    """This process's slots: its CUDA cards for None, else ``device`` (one
    device, or a list of them)."""
    if device is None:
        return _cards()
    if isinstance(device, (list, tuple)):
        return [torch.device(d) for d in device]
    return [torch.device(device)]


def group_mesh(slots: Sequence, *, axis_name: str = BATCH_AXIS,
               dcn_axis_name: str = "dcn") -> Mesh:
    """The (process, local slot) mesh over every process of the group, each
    process contributing ``slots`` (every process the same count).  Built
    for any group size, one process included; :func:`multihost_mesh` is the
    entry point."""
    import torch.distributed as dist

    mine = [str(_local_slot(d)) for d in slots]
    if not mine:
        raise ValueError("a process must hold at least one mesh slot")
    everyone = [None] * dist.get_world_size()
    cards = [d for d in slots if torch.device(d).type == "cuda"]
    # NCCL gathers the objects on the current card: make it this process's
    with torch.cuda.device(_local_slot(cards[0])) if cards else contextlib.nullcontext():
        dist.all_gather_object(everyone, mine)
    if len({len(s) for s in everyone}) != 1:
        raise ValueError("the processes hold different numbers of mesh slots: "
                         + ", ".join(f"rank {r}: {len(s)}" for r, s in enumerate(everyone)))
    owners = [[r] * len(s) for r, s in enumerate(everyone)]
    mesh = Mesh.__new__(Mesh)
    mesh._setup(everyone, (dcn_axis_name, axis_name), owners)
    mesh._group = True
    return mesh


def multihost_mesh(*, axis_name: str = BATCH_AXIS, dcn_axis_name: str = "dcn",
                   device=None) -> Optional[Mesh]:
    """A mesh over every process of the ``torch.distributed`` group: the
    (process, local slot) 2-D mesh with the process boundary on
    ``dcn_axis_name``.  Both axes carry the batch.

    ``device`` names this process's slots (a device or a list of them); None
    means its CUDA cards.  With one process (no group, or a group of one)
    it is the 1-D local mesh over those slots, or None for one slot, as
    :func:`default_mesh`.  Raises if the processes hold different numbers
    of slots."""
    slots = _slots_of(device)
    if _world_size() <= 1:
        if len(slots) <= 1:
            return None
        return Mesh(slots, (axis_name,))
    return group_mesh(slots, axis_name=axis_name, dcn_axis_name=dcn_axis_name)


@dataclasses.dataclass(frozen=True)
class ShardedArray:
    """This process's shards of a global array: ``shards[k]`` is the block
    of rows (``sharding.block_of``) that the k-th of this process's slots
    holds, a tensor on the slot's device (or a host array), and ``shape``
    the global shape."""

    shape: Tuple[int, ...]
    sharding: Sharding
    shards: Tuple


def _rows(arr, sharding: Sharding, slot: int):
    n = sharding.n_blocks
    if arr.shape[0] % n:
        raise ValueError(f"a leading axis of {arr.shape[0]} does not split into {n} blocks; "
                         "pad it first (pad_batch)")
    k = arr.shape[0] // n
    b = sharding.block_of(slot)
    return arr[b * k:(b + 1) * k]


def put_global(arr, sharding: Sharding) -> ShardedArray:
    """Place a global host array (numpy or a tensor) on a sharding: this
    process's blocks, each a tensor on its slot's device.  Across processes
    every process must hold the same global array."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
    return ShardedArray(tuple(t.shape), sharding, tuple(
        _rows(t, sharding, i).to(d) for i, d in sharding.mesh.local_slots()))


def put_global_tree(tree, sharding: Sharding):
    """:func:`put_global` over every array leaf of a dict, list or tuple."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: put_global_tree(v, sharding) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        leaves = [put_global_tree(v, sharding) for v in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else type(tree)(leaves)
    return put_global(tree, sharding)


def _gatherable(t: torch.Tensor) -> torch.Tensor:
    """A tensor every backend all-gathers: complex as real pairs, bool as
    uint8."""
    if t.is_complex():
        return torch.view_as_real(t.resolve_conj())
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def _restored(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(t.contiguous())
    return t.bool() if like.dtype == torch.bool else t


def fetch_global(x) -> np.ndarray:
    """The whole global array of ``x`` as a host numpy array.

    A :class:`ShardedArray` comes back block by block, each block taken
    once from the first slot that holds it; when its mesh spans processes,
    each process's shards are all-gathered over the group first (every
    process gets the whole array).  A tensor or anything else converts as
    it is."""
    if isinstance(x, torch.Tensor):
        return _fetch(x)
    if not isinstance(x, ShardedArray):
        return np.asarray(x)
    mesh, sh = x.sharding.mesh, x.sharding
    local = [s if isinstance(s, torch.Tensor) else torch.from_numpy(np.asarray(s))
             for s in x.shards]
    if mesh.spans_processes:
        by_rank = _all_gather_shards(local, mesh)
        seen = collections.defaultdict(int)
        shards = []
        for r in mesh.process_ids.ravel():
            shards.append(by_rank[r][seen[r]])
            seen[r] += 1
        slots = range(mesh.size)
    else:
        shards = local
        slots = [i for i, _d in mesh.local_slots()]
    blocks = {}
    for slot, t in zip(slots, shards):
        blocks.setdefault(sh.block_of(slot), t)
    if len(blocks) != sh.n_blocks:
        raise ValueError(f"the shards hold {len(blocks)} of {sh.n_blocks} blocks")
    out = np.concatenate([_fetch(blocks[b]) for b in range(sh.n_blocks)])
    return out.reshape(x.shape)


def _fetch(t: torch.Tensor) -> np.ndarray:
    with span("psa.fetch"):
        return t.detach().cpu().numpy()


def _all_gather_shards(local, mesh: Mesh) -> list:
    """Every process's shards, by rank: one all-gather over the group of
    this process's stacked shards (NCCL from its first card, gloo from the
    host)."""
    import torch.distributed as dist

    like = local[0]
    stacked = _gatherable(torch.stack([t.to(like.device) for t in local]))
    if dist.get_backend() == "nccl":
        cards = [d for _i, d in mesh.local_slots() if d.type == "cuda"]
        if not cards:
            raise RuntimeError("an NCCL group gathers from a card, and this process has no "
                               "CUDA slot in the mesh")
        stacked = stacked.to(cards[0])
    else:
        stacked = stacked.cpu()
    stacked = stacked.contiguous()
    parts = [torch.empty_like(stacked) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, stacked)
    return [list(_restored(p.cpu(), like)) for p in parts]


def pad_batch(arr: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis up to a multiple (edge-replicating the last row so
    padded instances stay numerically benign); returns (padded, original_n)."""
    n = arr.shape[0]
    if multiple <= 1 or n % multiple == 0:
        return arr, n
    pad = multiple - (n % multiple)
    pad_rows = np.repeat(arr[-1:], pad, axis=0)
    return np.concatenate([arr, pad_rows], axis=0), n


# ---------------------------------------------------------------------------
# The sharded solve the batched solvers share
# ---------------------------------------------------------------------------

def mesh_device(mesh, device) -> torch.device:
    """The device a solve builds its inputs on: ``resolve_device(device)``
    without a mesh, else this process's first slot.  ``mesh`` must be a port
    :class:`Mesh` (else ``TypeError``), and a solver's ``device`` must be
    None or agree with the slots this process holds: the same type, and,
    where it names an index, one of those slots."""
    if mesh is None:
        return resolve_device(device)
    slots = [d for _i, d in check_mesh(mesh).local_slots()]
    if not slots:
        raise ValueError("this process holds no slot of the mesh")
    if device is not None:
        want = torch.device(device)
        if any(d.type != want.type for d in slots) or (want.index is not None
                                                        and want not in slots):
            raise ValueError(f"device={want} disagrees with the mesh's slots "
                             f"{[str(d) for d in slots]}; pass device=None or one they use")
    return slots[0]


def _pad_rows(x, multiple: int):
    if isinstance(x, torch.Tensor):
        pad = -x.shape[0] % multiple
        return x if pad == 0 else torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return pad_batch(np.asarray(x), multiple)[0]


def _to_device(x, device: torch.device):
    """``x`` with its tensors on ``device``: a tensor, a dataclass or tuple
    of them; anything else (None, numbers, host arrays) as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _to_device(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple):
        return tuple(_to_device(v, device) for v in x)
    return x


def shard_batch(mesh, fn: Callable, args: Sequence, *, in_axes=0, out_axes=0) -> tuple:
    """Run ``fn(slot_device, *slot_args)`` for every slot of ``mesh`` that
    this process holds, and return its outputs as host numpy arrays over the
    whole batch.

    ``in_axes`` (one value, or one an argument) marks each argument as
    batched (``0``: split by rows over the slots, after padding to a
    multiple of the mesh's slots with edge rows) or shared (``None``: put on
    each device once).  A batched tensor lands on its slot's device, a
    batched host array stays on the host.  ``fn`` returns a tuple; each
    output with ``out_axes`` 0 is batched and comes back through
    :func:`fetch_global`, trimmed to the unpadded batch, and an output with
    ``out_axes`` None is taken from the first slot.  Every slot's inputs
    are on its device before the first ``fn`` runs, and every slot's ``fn``
    runs (launches) before any output is fetched."""
    mesh = check_mesh(mesh)
    in_axes = (in_axes,) * len(args) if not isinstance(in_axes, (list, tuple)) else in_axes
    batched = [a for a, ax in zip(args, in_axes) if ax == 0]
    if not batched or len(in_axes) != len(args):
        raise ValueError("shard_batch needs an in_axes entry for each argument and at least "
                         "one batched argument")
    n = int(batched[0].shape[0])
    sharding = batch_sharding(mesh)
    slots = mesh.local_slots()
    with span("psa.mesh.shard"):
        padded = [_pad_rows(a, sharding.n_blocks) if ax == 0 else a
                  for a, ax in zip(args, in_axes)]
        shared = {}
        for _slot, dev in slots:
            if str(dev) not in shared:
                shared[str(dev)] = [None if ax == 0 else _to_device(a, dev)
                                    for a, ax in zip(padded, in_axes)]

        def rows(a, slot, dev):
            part = _rows(a, sharding, slot)
            return part.to(dev) if isinstance(part, torch.Tensor) else part

        # Every slot's inputs reach its device before any slot launches: a
        # copy from another card waits for the work queued on that card, so a
        # kernel launched there first would hold the copy, and this slot, back.
        inputs = [[rows(a, slot, dev) if ax == 0 else rep
                   for a, ax, rep in zip(padded, in_axes, shared[str(dev)])]
                  for slot, dev in slots]
    outs = [tuple(fn(dev, *a)) for (_slot, dev), a in zip(slots, inputs)]
    wait(*(dev for _slot, dev in slots))
    out_axes = (out_axes,) * len(outs[0]) if not isinstance(out_axes, (list, tuple)) \
        else out_axes
    n_pad = n + (-n % sharding.n_blocks)
    result = []
    with span("psa.mesh.gather"):
        for k, ax in enumerate(out_axes):
            first = outs[0][k]
            if ax is None:
                result.append(fetch_global(first))
                continue
            shape = (n_pad,) + tuple(first.shape[1:])
            result.append(
                fetch_global(ShardedArray(shape, sharding, tuple(o[k] for o in outs)))[:n])
    return tuple(result)
