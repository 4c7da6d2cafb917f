"""LDS of Data-Banzhaf attributions for the text-to-image workload.

Port of the JAX package's ``cli/banzhaf_lds.py`` (reference
text_to_image/banzhaf_lds.py): `data_banzhaf` on uniform-removal DBs,
evaluated against datamodel-retrain test DBs. `main` returns the
attributions.
"""

from ..attributions.methods import data_banzhaf
from ._tti_lds import base_parser, run_lds


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    return run_lds(args, "uniform", lambda m, b: data_banzhaf(m, b).ravel())


if __name__ == "__main__":
    main()
