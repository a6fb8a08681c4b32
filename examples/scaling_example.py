"""Scaling walkthrough: sharded queries, multi-host wiring, and the
int64 engine past 2^31 columns.

Run with a virtual device mesh (no multi-GPU host needed):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/scaling_example.py
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from sbwt_tpu.models.sbwt import SBWT
from sbwt_tpu.parallel import sharded
from sbwt_tpu.utils.dna import encode_query

rng = np.random.default_rng(0)
genome = "".join(rng.choice(list("ACGT"), size=5000))
sbwt = SBWT.build([genome], k=20, precalc_k=6)

# --- data-parallel queries over an 8-device mesh -------------------------
mesh = sharded.make_mesh()  # (data, model) over all visible devices
reads = [genome[i * 40 : i * 40 + 80] for i in range(32)]
codes = np.stack([encode_query(r) for r in reads]).astype(np.int8)
lengths = np.full(len(reads), codes.shape[1], dtype=np.int32)

index = sharded.replicate_index(sbwt.device_index, mesh)
ans_dp = sharded.dp_streaming_search(index, codes, lengths, mesh)

# --- tensor-parallel: the rank tables row-sharded over `model` -----------
mesh_tp = sharded.make_mesh(n_model=2)
ans_tp = sharded.tp_streaming_search(sbwt.device_index, codes, lengths, mesh_tp)
assert np.array_equal(np.asarray(ans_dp), np.asarray(ans_tp))
print("DP == TP over", np.asarray(ans_dp).shape, "answers")

# --- multi-host: same calls, real process boundaries ----------------------
# On a pod each host runs (see tests/multihost_worker.py for a live
# 2-process example driven by tests/test_multihost_mp.py):
#
#   multihost.init_multihost(coordinator, num_processes, process_id)
#   mesh  = multihost.global_mesh()
#   mine  = multihost.my_read_slice(query_files)      # host-local I/O
#   ans   = multihost.distributed_streaming_search(index, codes, lens, mesh)
#   write(multihost.local_shard(ans))                 # host-local output

# --- past 2^31 columns -----------------------------------------------------
# Indexes with >= 2^31 columns route to the int64 engine automatically:
# models.matrix.from_packed_rows / SBWT.from_packed pick models.wide.
# tests/test_wide_index.py builds the complete order-16 de Bruijn graph
# (4^16 + 1 = 4.29 billion columns) and validates answers up to 2^32
# against a closed-form oracle.
from sbwt_tpu.utils.memory import select_turbo_arity

print("turbo tier at 100M columns with 30 GB free:",
      select_turbo_arity(100_000_000, free_bytes=30 << 30))
