"""Multi-host execution: jax.distributed runtime + host-sharded query I/O.

The reference is a single-address-space program (CMakeLists.txt:99, no
MPI/NCCL anywhere); scaling past one machine means running independent
processes on manually split inputs.  Here multi-host is a first-class
runtime mode: `jax.distributed` brings every host's chips into one global
mesh, each host reads only its slice of the query files, the global
batch is assembled from process-local shards without any host ever
holding the full input, and the per-read answers come back as
process-local shards for each host to write.  XLA hands the collectives
to the backend's transport (NCCL between GPUs) — placement is
configuration (the mesh + PartitionSpecs), not communication code.

Typical flow on each host::

    init_multihost(coordinator, num_processes, process_id)
    mesh = global_mesh(n_model=1)
    reads = my_read_slice(all_files)            # host-local I/O
    ans   = distributed_streaming_search(index_host_arrays, codes, lens, mesh)
    write_answers(local_shard(ans, mesh))       # host-local output

Single-process (tests, one host) degenerates to the plain DP/TP path:
every helper works unchanged with jax.process_count() == 1.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import sharded
from ..models.matrix import MatrixIndex


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the cross-host runtime (no-op when single-process).

    Wraps jax.distributed.initialize; safe to call twice.  With no
    arguments, discovery falls back to the JAX_COORDINATOR_ADDRESS /
    cluster-environment auto-detection built into jax.distributed.
    """
    if num_processes is not None and num_processes <= 1 and coordinator_address is None:
        return
    try:
        # Cross-process collectives on CPU hosts need the gloo transport
        # (GPU backends use NCCL; this setting only affects the CPU).
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def global_mesh(n_model: int = 1) -> Mesh:
    """(data, model) mesh over every chip of every host.

    jax.devices() is the *global* device list under jax.distributed, so
    this is the same constructor as the single-host path."""
    return sharded.make_mesh(n_model=n_model)


def my_read_slice(items: list, process_id: int | None = None, n: int | None = None) -> list:
    """The contiguous slice of `items` (query files, reads, ...) this host
    is responsible for reading.  Hosts with no items get an empty list."""
    pid = jax.process_index() if process_id is None else process_id
    np_ = jax.process_count() if n is None else n
    per = -(-len(items) // np_)
    return items[pid * per : (pid + 1) * per]


def global_batch_from_local(local: np.ndarray, mesh: Mesh, pad_to: int | None = None):
    """Assemble a global device array sharded over `data` from each
    process's local rows.  No host ever materializes the full batch.

    Every process must call this collectively.  Local row counts must be
    equal across processes (pad with -1 rows via `pad_to` if not)."""
    if pad_to is not None and local.shape[0] < pad_to:
        pad = np.full((pad_to - local.shape[0],) + local.shape[1:], -1, local.dtype)
        local = np.concatenate([local, pad])
    spec = P("data") if local.ndim == 1 else P("data", *([None] * (local.ndim - 1)))
    return jax.make_array_from_process_local_data(NamedSharding(mesh, spec), local)


def local_shard(global_array) -> np.ndarray:
    """This host's rows of a data-sharded global result, in order.

    Replicated copies (e.g. over a model axis) are deduplicated by row
    range — each range contributes exactly once."""
    by_start = {}
    for s in global_array.addressable_shards:
        start = s.index[0].start or 0
        if start not in by_start:
            by_start[start] = s
    return np.concatenate(
        [np.asarray(by_start[st].data) for st in sorted(by_start)]
    )


def replicate_index_global(index: MatrixIndex, mesh: Mesh) -> MatrixIndex:
    """Replicate the index on every chip of every host.

    Each host uploads from its own RAM copy (the index file is read
    per-host); under jax.distributed device_put with a fully-replicated
    NamedSharding places host-local copies without cross-host traffic."""
    return sharded.replicate_index(index, mesh)


def distributed_streaming_search(
    index: MatrixIndex, local_codes: np.ndarray, local_lengths: np.ndarray, mesh: Mesh
):
    """Streaming search over a multi-host mesh; returns the global answer
    array (call local_shard() for this host's rows)."""
    codes = global_batch_from_local(local_codes, mesh)
    lengths = global_batch_from_local(local_lengths, mesh)
    from ..ops import search as engines

    fn = jax.jit(
        engines.streaming_search,
        out_shardings=NamedSharding(mesh, P("data", None)),
    )
    return fn(index, codes, lengths)


def distributed_turbo_streaming_search(
    turbo, index: MatrixIndex, local_codes: np.ndarray, local_lengths: np.ndarray, mesh: Mesh
):
    """Turbo streaming search over a multi-host mesh (replicated tables,
    data-sharded reads, zero collectives on the hot path)."""
    codes = global_batch_from_local(local_codes, mesh)
    lengths = global_batch_from_local(local_lengths, mesh)
    from ..ops.turbo import turbo_streaming_search

    def body(turbo_l, index_l, codes_l, lengths_l):
        return turbo_streaming_search(turbo_l, index_l, codes_l, lengths_l)

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), P(), P("data", None), P("data")),
            out_specs=P("data", None),
        )
    )
    repl = NamedSharding(mesh, P())
    turbo = jax.tree.map(lambda x: jax.device_put(x, repl), turbo)
    index = jax.tree.map(lambda x: jax.device_put(x, repl), index)
    return fn(turbo, index, codes, lengths)


def all_hosts_agree(value: int) -> bool:
    """Cheap cross-host sanity check (e.g. that every host loaded the same
    index: pass n_nodes).  True iff `value` matches on all processes."""
    if jax.process_count() == 1:
        return True
    from jax.experimental import multihost_utils

    vals = multihost_utils.process_allgather(jnp.asarray([value]))
    return bool(np.all(np.asarray(vals) == value))
