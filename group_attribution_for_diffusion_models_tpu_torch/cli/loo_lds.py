"""LDS of leave-one-out attributions for the text-to-image workload.

Port of the JAX package's ``cli/loo_lds.py`` (reference
text_to_image/loo_lds.py): attrs[i] = y_full - y_loo(i) (reference :175),
evaluated against datamodel-retrain test DBs. --v1 is the full-model
behavior. `main` returns the attributions.
"""

import numpy as np

from ._tti_lds import base_parser, run_lds


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)

    def fit(masks, behaviors):
        attrs = np.zeros(args.num_groups)
        v1 = float(args.v1 if args.v1 is not None else behaviors.max())
        for mask, y in zip(masks, behaviors):
            out = np.flatnonzero(mask == 0)
            if len(out) == 1:
                attrs[out[0]] = v1 - y
        return attrs

    return run_lds(args, "loo", fit)


if __name__ == "__main__":
    main()
