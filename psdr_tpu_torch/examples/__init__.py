"""The JAX package's six example scripts, ported. Each runs as
``python -m psdr_tpu_torch.examples.<name>`` with ``--out DIR`` (default
``out/``), ``--device`` (default ``cuda``; ``cpu`` for a run without a
card) and ``--small`` (a CPU-sized scene): ``render_simple``,
``validate_gradients``, ``inverse_albedo``, ``inverse_geometry``,
``multiview_inverse`` (through ``parallel.make_multiview_train_step``, one
process a rank) and ``flagship_recovery``."""
import argparse
import os


def parser(doc: str) -> argparse.ArgumentParser:
    """The options every example takes."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: the card)")
    p.add_argument("--small", action="store_true",
                   help="a small scene, for a quick run on the CPU")
    return p


def out_dir(args) -> str:
    os.makedirs(args.out, exist_ok=True)
    return args.out
