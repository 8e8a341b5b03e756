"""CLI: `python -m nextpolish_tpu run.cfg` (source/nextPolish:532-553)."""
from __future__ import annotations

import argparse
import logging
import sys

from . import __version__
from .config import load_config
from .kit import plog


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="nextpolish_tpu",
        description="Genome polishing on JAX devices (NextPolish capabilities).",
    )
    parser.add_argument("config", help="run.cfg configuration file")
    parser.add_argument("-l", "--log", default=None, help="log file")
    parser.add_argument("-v", "--version", action="version",
                        version=f"%(prog)s {__version__}")
    args = parser.parse_args(argv)

    log = plog()
    if args.log:
        handler = logging.FileHandler(args.log)
        handler.setFormatter(log.handlers[0].formatter)
        log.addHandler(handler)

    # before importing the pipeline: jax.distributed must initialize before
    # anything touches the XLA backend
    from .parallel.hosts import init_distributed

    nproc = init_distributed()
    if nproc > 1:
        import jax

        log.info("multi-host run: rank %d of %d", jax.process_index(), nproc)
    from .pipeline import Pipeline

    cfg = load_config(args.config)
    log.info("scheduled tasks: %s", cfg.task)
    asm = Pipeline(cfg).run()
    log.info("done: %s", asm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
