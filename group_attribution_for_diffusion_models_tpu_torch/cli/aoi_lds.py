"""LDS of add-one-in attributions for the text-to-image workload.

Port of the JAX package's ``cli/aoi_lds.py`` (reference
text_to_image/aoi_lds.py): attrs[i] = y_aoi(i) - y_null (reference :176),
evaluated against datamodel-retrain test DBs. --v0 is the null-model
behavior. `main` returns the attributions.
"""

import numpy as np

from ._tti_lds import base_parser, run_lds


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)

    def fit(masks, behaviors):
        attrs = np.zeros(args.num_groups)
        v0 = float(args.v0 if args.v0 is not None else behaviors.min())
        for mask, y in zip(masks, behaviors):
            kept = np.flatnonzero(mask == 1)
            if len(kept) == 1:
                attrs[kept[0]] = y - v0
        return attrs

    return run_lds(args, "aoi", fit)


if __name__ == "__main__":
    main()
