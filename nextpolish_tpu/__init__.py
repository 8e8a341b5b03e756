"""nextpolish_tpu — a JAX genome-polishing framework.

A from-scratch reimplementation of the capabilities of NextPolish
(Nextomics/NextPolish) as JAX tensor programs for an accelerator:

* the short-read (SGS) polishing engine — score-chain Viterbi + k-mer vote —
  is reformulated as dense tensor programs: pileups become count tensors,
  the score chain becomes a tropical ((max,+)) matrix scan executed with
  ``jax.lax.associative_scan`` so a whole genome window is corrected in
  log-depth instead of a sequential pointer-chasing DP;
* the long-read / HiFi consensus engine (``ctg_cns``) becomes a batched
  (position, delta, base) lattice DP over windows;
* parallelism is expressed with ``jax.sharding`` over device meshes
  (windows are the batch axis; pileup merges are ``psum`` collectives)
  instead of cluster job files.

Layer map (mirrors SURVEY.md §1 of the reference):

    pipeline   driver: config -> rounds -> stages          (pipeline.py, cli.py)
    runtime    local scheduler, retries, resume            (runtime/)
    models     polishing engines (tasks 1-6)               (models/)
    ops        Pallas/JAX kernels: pileup, tropical scan,
               consensus DP, POA, banded alignment         (ops/)
    align      minimizer seed-chain-extend aligner          (align/)
    parallel   mesh, shardings, collectives                (parallel/)
    io         FASTA/FASTQ/BAM, 2-bit codec, read split    (io/)
"""

__version__ = "0.1.0"

import os as _os

# the one place the persistent XLA compilation cache is configured:
# JAX_COMPILATION_CACHE_DIR wins when set (JAX reads it itself); otherwise
# a fixed directory inside the checkout, so every process of one checkout
# shares it and nothing is written outside the checkout
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _configure_compile_cache() -> None:
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


_configure_compile_cache()
