"""Dataset format converter.

    python -m sxmc_jax.io.convert input.root output.sxnt
    python -m sxmc_jax.io.convert a.npz b.npz merged.hdf5

Reads any supported ntuple format (.npz/.npy/.csv/.hdf5/.sxnt, .root
via uproot), concatenates multiple inputs with a field-layout check
(ttree_io.cpp:124-126 semantics), and writes any supported output
format.  The one-command migration path from the reference's ROOT
ntuples to the native mmap columnar store (docs/MIGRATION.md).
"""

from __future__ import annotations

import sys

from sxmc_jax.io.loaders import read_float_tables, write_float_table


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or "-h" in argv or "--help" in argv:
        print(__doc__.strip())
        return 0 if ("-h" in argv or "--help" in argv) else 2
    *inputs, output = argv
    data, fields = read_float_tables(inputs)
    write_float_table(output, data, fields)
    print(f"convert: {len(inputs)} file(s), {data.shape[0]} rows, "
          f"fields {fields} -> {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
