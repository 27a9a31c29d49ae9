"""Multi-host orchestration helpers.

For gallery scale-out beyond one machine and multi-host embedding jobs,
this module wraps the ``torch.distributed`` bootstrap and provides the
host-sharding conventions:

  * within a machine: gallery rows shard over the ``gallery`` mesh axis
    (``gallery/sharded.py``);
  * across hosts: each host owns a contiguous row range of the global
    gallery (``host_shard_range``); queries go to every host and per-host
    top-k lists merge on the host (``merge_host_topk``; k is tiny, so the
    traffic is O(hosts × k) per query batch). The shard router
    (``gallery/router.py``) merges through it.

Single-process use needs none of this: every function is a no-op or the
identity when no process group exists.
"""

from __future__ import annotations

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)


def _group_exists() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str | torch.device = "cuda") -> None:
    """``torch.distributed.init_process_group`` over
    ``tcp://<coordinator_address>`` (NCCL on CUDA, gloo on the CPU).

    A no-op without arguments (a single-process run) and when a process
    group already exists. Any other bootstrap failure raises: degrading to
    one process would make ``host_shard_range`` give this host the WHOLE
    gallery, and the job would silently write overlapping shards."""
    if coordinator_address is None and num_processes is None:
        return
    if _group_exists():
        return
    import torch.distributed as dist

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process
    group."""
    if not _group_exists():
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def host_shard_range(n_rows: int, process_id: int | None = None,
                     process_count: int | None = None) -> tuple[int, int]:
    """Contiguous [start, end) row range this host owns of a global
    gallery of n_rows (balanced, first hosts take the remainder)."""
    rank, world = process_info()
    pid = rank if process_id is None else process_id
    pcount = world if process_count is None else process_count
    base = n_rows // pcount
    rem = n_rows % pcount
    start = pid * base + min(pid, rem)
    end = start + base + (1 if pid < rem else 0)
    return start, end


def merge_host_topk(
    per_host_scores: list[np.ndarray],  # each [Q, k]
    per_host_indices: list[np.ndarray],  # each [Q, k], GLOBAL row ids
    k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side merge of per-host top-k candidate lists."""
    scores = np.concatenate(per_host_scores, axis=1)
    indices = np.concatenate(per_host_indices, axis=1)
    order = np.argsort(-scores, axis=1)[:, :k]
    return (np.take_along_axis(scores, order, axis=1),
            np.take_along_axis(indices, order, axis=1))
