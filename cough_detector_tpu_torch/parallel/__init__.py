"""Processes, devices and collectives: data-parallel training over
torch.distributed and scoring over a mesh of devices. `launch.run_ranks`
(imported from `parallel.launch`, the module its child ranks run) starts
the ranks of a training mesh."""

from .mesh import (
    BatchSlice,
    Mesh,
    active_slice,
    all_gather_rows,
    all_reduce_sum,
    batch_slice,
    corpus_shard,
    local_row_bounds,
    make_mesh,
    maybe_initialize_distributed,
    mesh_arg,
    pad_to_multiple,
    process_group,
    rank_device,
    reduce_scatter_rows,
    reducing_group,
    resolve_mesh,
    resolve_train_mesh,
    routed_gather,
    rows_of,
)

__all__ = [
    "BatchSlice", "Mesh", "active_slice", "all_gather_rows", "all_reduce_sum",
    "batch_slice", "corpus_shard", "local_row_bounds", "make_mesh",
    "maybe_initialize_distributed", "mesh_arg", "pad_to_multiple", "process_group",
    "rank_device", "reduce_scatter_rows", "reducing_group", "resolve_mesh",
    "resolve_train_mesh", "routed_gather", "rows_of",
]
