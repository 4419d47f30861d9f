"""Devices, ranks and the collectives of data-parallel training, in torch.

The port of `cough_detector_tpu/parallel/mesh.py`. The JAX package runs one
process over a mesh of devices and lets XLA place the collectives; the port
runs one process per card under `torch.distributed` for training, and one
process over a list of devices for scoring:

  * `maybe_initialize_distributed` joins the process group torchrun's
    environment describes (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
    `MASTER_ADDR`, `MASTER_PORT`). Each rank trains on its own rows of
    every global batch (`local_row_bounds`), and the train step reduces
    across the group: the BatchNorm sums (models/layers.py), the loss's
    weight sum and the gradients (train/steps.py).
  * `BatchSlice` says which rows of the global batch the tensors in hand
    are. While one is active (`batch_slice`), every random draw of the
    step (augmentation, SpecAugment, dropout, MixUp) is made for the
    global batch and cut to these rows, so each row sees the draws the
    one-process run gives it.
  * `Mesh` is an ordered list of devices the stream or batch axis splits
    over, in contiguous equal blocks (the detector, offline scoring,
    evaluate and featurize). A device may appear twice. Training over a
    mesh (`resolve_train_mesh`) runs one rank a device, started by
    `parallel/launch.py::run_ranks`.
  * `routed_gather` reads batch rows from a corpus sharded by rows over the
    ranks, equal bit for bit to `index_select` on the whole corpus.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


# -- processes ---------------------------------------------------------------------


def maybe_initialize_distributed(
    backend: Optional[str] = None, device: Optional[Union[str, torch.device]] = None
) -> bool:
    """Join the process group torchrun's environment describes; False (and
    nothing done) without that environment, True once joined. A failed
    init raises.

    `backend`: None means "nccl" when CUDA is available, each rank taking
    the card `LOCAL_RANK` (it raises when more ranks share the node than it
    has cards: NCCL refuses two ranks on one card, so that case asks for
    "gloo" explicitly), and "gloo" on a host without a card. `device`: the
    card an NCCL rank takes instead of `cuda:LOCAL_RANK` (a mesh's device)."""
    if not all(os.environ.get(k) for k in _TORCHRUN_ENV):
        return False
    local_rank = int(os.environ["LOCAL_RANK"])
    if backend is None:
        if torch.cuda.is_available():
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
            if local_world > torch.cuda.device_count():
                raise ValueError(
                    f"{local_world} ranks on a node with {torch.cuda.device_count()} card(s): "
                    f"NCCL takes one rank a card; pass backend='gloo' for ranks that share one"
                )
            backend = "nccl"
        else:
            backend = "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank if device is None else torch.device(device))
    dist.init_process_group(
        backend, init_method="env://",
        world_size=int(os.environ["WORLD_SIZE"]), rank=int(os.environ["RANK"]),
    )
    return True


def process_group() -> Optional[dist.ProcessGroup]:
    """The default process group when one is initialized, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def rank_device(device: Union[str, torch.device]) -> torch.device:
    """The device a rank trains on: `cuda:LOCAL_RANK` for an unindexed
    "cuda", else `device` as given (an explicit index, or the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def local_row_bounds(pad_to: int, rank: int, world: int) -> Tuple[int, int]:
    """Rows [lo, hi) of a global batch padded to `pad_to` (a multiple of
    `world`) that `rank` builds and trains on: contiguous equal blocks in
    rank order (the JAX loop's `_local_row_bounds`)."""
    if pad_to % world:
        raise ValueError(f"a batch of {pad_to} rows does not split over {world} ranks")
    per = pad_to // world
    return rank * per, (rank + 1) * per


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0) -> Tuple[np.ndarray, int]:
    """Zero-pad `axis` up to a multiple of `multiple`; returns (padded,
    original length)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, rem)
    return np.pad(arr, widths), n


# -- the rows in hand ----------------------------------------------------------------


class BatchSlice(NamedTuple):
    """Rows [lo, hi) of a global batch of `total` rows. `group`, when set,
    is the process group whose ranks hold the other rows: batch statistics
    (BatchNorm, the loss's weight sum, MixUp's partners) are then reduced
    across it."""

    lo: int
    hi: int
    total: int
    group: Optional[dist.ProcessGroup] = None

    def take(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This slice's rows of a global-batch tensor (batch axis `dim`)."""
        if self.lo == 0 and self.hi == self.total:
            return t
        return t.narrow(dim, self.lo, self.hi - self.lo)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("cdt_batch_slice", default=None)


@contextlib.contextmanager
def batch_slice(sl: Optional[BatchSlice]) -> Iterator[None]:
    """Make `sl` the rows the code in the block holds (None: the whole
    batch, as without the block)."""
    token = _ACTIVE.set(sl)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_slice() -> Optional[BatchSlice]:
    return _ACTIVE.get()


def rows_of(b: int) -> BatchSlice:
    """The active slice for a batch of `b` rows in hand, or the whole batch
    (0, b, b) outside `batch_slice`."""
    sl = _ACTIVE.get()
    if sl is None:
        return BatchSlice(0, b, b)
    if sl.hi - sl.lo != b:
        raise ValueError(f"a batch of {b} rows in hand, but the active slice holds rows {sl.lo}:{sl.hi}")
    return sl


def reducing_group() -> Optional[dist.ProcessGroup]:
    """The active slice's group when it spans more than one rank, else None.
    With one rank every reduction is the local value, so the layers keep
    their one-process code (as nn.SyncBatchNorm does)."""
    sl = _ACTIVE.get()
    if sl is None or sl.group is None or sl.world == 1:
        return None
    return sl.group


# -- collectives ---------------------------------------------------------------------

# Both backends run every collective the layer uses (all-reduce,
# all-gather, reduce-scatter) on CUDA tensors as on CPU ones, gloo too, so
# no backend needs another form: chip_smoke.py runs two gloo ranks on one
# card and NCCL at world size 1 through them.


def all_reduce_sum(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Sum of `t` over the group's ranks, differentiable: the backward pass
    sums the incoming gradients across the ranks too."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def all_gather_rows(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The ranks' (n, ...) tensors stacked in rank order, (world*n, ...);
    no gradient flows through it."""
    world = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def reduce_scatter_rows(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Rank r's block of rows of the sum of every rank's (world*n, ...) `t`,
    in one reduce-scatter."""
    world = dist.get_world_size(group)
    if t.shape[0] % world:
        raise ValueError(f"{t.shape[0]} rows do not split over {world} ranks")
    out = torch.empty((t.shape[0] // world,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def corpus_shard(rows_fn, n_rows: int, rank: int, world: int) -> np.ndarray:
    """Rank `rank`'s rows of a corpus of `n_rows` padded with zero rows to a
    multiple of `world`: rows [rank*per, (rank+1)*per), read through
    `rows_fn(global indices)` (ShardLoader.corpus_rows). The pad rows are
    never indexed."""
    per = -(-n_rows // world)
    lo = rank * per
    real = np.arange(lo, min(lo + per, n_rows))
    rows = rows_fn(real)
    out = np.zeros((per,) + rows.shape[1:], rows.dtype)
    out[: len(real)] = rows
    return out


def routed_gather(
    shard: torch.Tensor, idx: torch.Tensor, group: Optional[dist.ProcessGroup] = None
) -> torch.Tensor:
    """Batch rows from a corpus sharded by rows over the group's ranks (rank
    r holds rows [r*per, (r+1)*per), `corpus_shard`): `idx` is this rank's
    block of the global batch's indices, and the result its rows, equal bit
    for bit to `corpus.index_select(0, idx)` (JAX: `make_routed_gather`).

    Every rank all-gathers the indices, takes the rows it owns (zeros
    elsewhere) and a reduce-scatter hands each rank its own block: exactly
    one rank contributes each row, so the sum is the row. The rows travel
    as int32 (neither NCCL nor gloo sums int16). Per step this moves one
    batch between the ranks, where a replicated corpus would hold all of it
    on every card."""
    rank = dist.get_rank(group)
    per = shard.shape[0]
    every = all_gather_rows(idx.to(torch.int64), group)
    lo = rank * per
    owned = (every >= lo) & (every < lo + per)
    rows = shard.index_select(0, (every - lo).clamp(0, per - 1))
    wide = rows.to(torch.int32) if rows.dtype == torch.int16 else rows
    contrib = torch.where(owned.view((-1,) + (1,) * (rows.ndim - 1)), wide, torch.zeros_like(wide))
    return reduce_scatter_rows(contrib, group).to(shard.dtype)


# -- meshes of devices -------------------------------------------------------------


class Mesh:
    """An ordered list of devices that a batch or stream axis splits over in
    contiguous equal blocks, device i taking block i. A device may appear
    more than once (two blocks on one card, or ["cpu", "cpu"] in tests)."""

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def blocks(self, n: int) -> List[Tuple[int, int]]:
        """Each device's rows [lo, hi) of an axis of n (a multiple of the
        mesh size)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over the mesh's {self.size} devices")
        per = n // self.size
        return [(i * per, (i + 1) * per) for i in range(self.size)]


def make_mesh(devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """A mesh over `devices`, or over every visible card by default (raises
    when there is none)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() spans the visible cards, and none is visible")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def mesh_arg(value: Optional[str]) -> Optional[List[str]]:
    """A CLI's --mesh value ("cuda:0,cuda:1") as a device list, or None."""
    return None if value is None else [d.strip() for d in value.split(",") if d.strip()]


def resolve_mesh(mesh, device: Union[str, torch.device], divides: Optional[int] = None) -> Optional[Mesh]:
    """The mesh a scoring entry point runs on. `mesh`: a Mesh or a device
    list (used as given), False (one device), or None: every visible card
    when `device` names the card without an index, more than one card is
    visible and (with `divides`) their count divides it; else one device."""
    if mesh is False:
        return None
    if mesh is None:
        dev = torch.device(device)
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.type == "cuda" and dev.index is None and n > 1 and (divides is None or divides % n == 0):
            return make_mesh()
        return None
    if isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, (list, tuple)):
        return Mesh(mesh)
    raise TypeError(f"mesh={mesh!r}: expected a Mesh, a list of devices, None or False")


def resolve_train_mesh(mesh, device: Union[str, torch.device], batch_size: Optional[int] = None) -> Optional[Mesh]:
    """The mesh `train()` runs data-parallel over, one rank a device, or
    None for one process (JAX: train/loop.py's mesh). `mesh`: False (one
    device); None: every visible card when `device` names the card without
    an index, more than one card is visible and no process group is
    initialized (inside one, the group's ranks are the run's), else one
    device; a Mesh or a device list, used as given (a device may repeat:
    ["cuda:0", "cuda:0"] puts two ranks on one card, ["cpu", "cpu"] two on
    the host). A card without an index gets the current one.

    Raises ValueError, before any work, for a mesh inside an initialized
    process group, a mesh that mixes the CPU and cards, a card past the
    visible ones, any other type, and a `batch_size` (given when the
    batches cannot pad: a corpus on the device) that the mesh does not
    divide; RuntimeError for cards on a host without one."""
    if mesh is None and process_group() is not None:
        return None
    try:
        mesh = resolve_mesh(mesh, device)
    except (RuntimeError, TypeError) as err:  # a bad device string, or not a mesh at all
        raise ValueError(f"not a training mesh: {err}") from err
    if mesh is None:
        return None
    if process_group() is not None:
        raise ValueError(
            f"a mesh of {mesh.size} devices inside an initialized process group: the group's ranks "
            f"already train data-parallel (pass mesh=None), and a mesh would start ranks inside ranks"
        )
    kinds = {d.type for d in mesh.devices}
    if not kinds <= {"cpu", "cuda"} or len(kinds) > 1:
        raise ValueError(
            f"mesh {[str(d) for d in mesh.devices]}: a training mesh is all cards or all the CPU"
        )
    devices = mesh.devices
    if kinds == {"cuda"}:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass a mesh of 'cpu' devices to train on the CPU")
        current = torch.cuda.current_device() if torch.cuda.is_initialized() else 0
        devices = [torch.device("cuda", current if d.index is None else d.index) for d in devices]
        past = [str(d) for d in devices if d.index >= torch.cuda.device_count()]
        if past:
            raise ValueError(f"mesh names {past}, past the {torch.cuda.device_count()} visible card(s)")
    if batch_size is not None and batch_size % mesh.size:
        raise ValueError(
            f"batch_size={batch_size} does not split over the mesh's {mesh.size} devices, and a corpus "
            f"on the device takes whole per-device blocks of every batch"
        )
    return Mesh(devices)
