"""LDS of closed-form Shapley attributions for the text-to-image workload.

Port of the JAX package's ``cli/shapley_lds.py`` (reference
text_to_image/shapley_lds.py:105-304): fit `data_shapley` on (artist-mask,
behavior) rows from shapley-removal DBs (baseline retrain vs sparse_gd
method) at scaled fit sizes; evaluate against datamodel-retrain test DBs;
save attributions + global artist ranking. numpy on the host; `main`
returns the attributions.
"""

from ._tti_lds import base_parser, run_lds, shapley_fit


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    return run_lds(args, "shapley", shapley_fit(args))


if __name__ == "__main__":
    main()
