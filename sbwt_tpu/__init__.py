"""sbwt-tpu: an accelerator-native SBWT k-mer index framework in JAX.

A from-scratch JAX/XLA implementation of the Spectral Burrows-Wheeler
Transform k-mer membership index, with the capabilities of the reference
C++ implementation (algbio/SBWT): construction from FASTA/FASTQ,
per-k-mer and streaming membership queries, variants, serialization
(including the reference's on-disk format), and a CLI — re-designed as
batched lockstep device programs instead of scalar rank loops.

Top-level names are lazy (PEP 562): importing the package does not pull
in jax, so host-only paths (native readers, external construction under
tight RLIMIT_AS, CLI startup) stay light until a device index is built.
"""

__version__ = "0.1.0"

__all__ = ["SBWT", "VARIANT_NAMES"]


def __getattr__(name):
    if name in __all__:
        from .models import sbwt as _sbwt

        return getattr(_sbwt, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
