"""Parameter-trace plotting CLI.

Standalone equivalent of the reference's ``bin/time_plot`` script
(reference: bin/time_plot:1-33), which plots each parameter of a saved
likelihood-space ntuple against the MCMC step:

    python -m sxmc_jax.time_plot lspace_0.hdf5 [outdir] [param ...]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="sxmc_jax.time_plot",
        description="Plot parameter traces from a saved likelihood space")
    parser.add_argument("lspace", help="saved likelihood-space file "
                                       "(.hdf5/.npz/.csv)")
    parser.add_argument("outdir", nargs="?", default=".",
                        help="output directory (default: cwd)")
    parser.add_argument("params", nargs="*",
                        help="parameters to plot (default: all)")
    args = parser.parse_args(argv)

    from sxmc_jax.observability import plot_traces
    from sxmc_jax.stats.likelihood import LikelihoodSpace

    ls = LikelihoodSpace.load(args.lspace)
    names = args.params or None
    out = plot_traces(ls, args.outdir, names=names)
    print(f"time_plot: wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
