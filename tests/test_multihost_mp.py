"""Multi-host execution with REAL process boundaries.

Spawns 2 jax.distributed CPU processes (2 virtual devices each -> a
4-device global mesh), each of which loads the index from disk, reads its
own query-file slice, runs the distributed streaming search (DP replicated
index, and TP row-sharded with cross-process psum collectives over gloo),
and writes its local answer shard.  The concatenated shards must equal the
single-process answers byte-for-byte — converting §2.6's multi-host claim
from configuration into evidence."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from sbwt_tpu.models.sbwt import SBWT
from sbwt_tpu.io.serialize import save
from sbwt_tpu.utils.dna import encode_query

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

K = 9
SEQ = (
    "CCCGTGATGGCTAGCTAGCTGATCGATCGTACGTACGTAGCTAGCATCGGATTACAGT"
    "ACCGTTGATTGCCGTAAGGCTTAAACCGGTTAACCGGATCGATTACA"
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _make_reads(rng, n):
    reads = []
    for i in range(n):
        ln = int(rng.integers(20, 100))
        if rng.random() < 0.5:
            st = int(rng.integers(0, len(SEQ) - ln))
            reads.append(SEQ[st : st + ln])
        else:
            reads.append("".join(rng.choice(list("ACGT"), size=ln)))
    return reads


@pytest.mark.slow
def test_two_process_distributed_search(tmp_path):
    sbwt = SBWT.build([SEQ], K, precalc_k=3)
    index_path = str(tmp_path / "index.sbwt")
    save(index_path, sbwt, "native")

    rng = np.random.default_rng(17)
    per_file = 10
    files = []
    all_reads = []
    for fi in range(2):
        reads = _make_reads(rng, per_file)
        all_reads.extend(reads)
        path = str(tmp_path / f"q{fi}.fastq")
        with open(path, "w") as f:
            for i, r in enumerate(reads):
                f.write(f"@r{fi}_{i}\n{r}\n+\n{'I' * len(r)}\n")
        files.append(path)

    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT
    env.pop("XLA_FLAGS", None)
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), index_path,
             str(tmp_path), str(per_file)] + files,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-4000:]}"

    # expected: single-process streaming answers in CLI text format
    L = 120
    expected_lines = []
    for r in all_reads:
        if len(r) < K:
            expected_lines.append("\n")
            continue
        ans = sbwt.streaming_search(r)
        expected_lines.append("".join(f"{v} " for v in ans) + "\n")

    for prefix in ["dp", "tp"]:
        got = []
        for pid in range(2):
            with open(tmp_path / f"{prefix}_out_{pid}.txt") as f:
                got.extend(f.readlines())
        assert got == expected_lines, prefix
