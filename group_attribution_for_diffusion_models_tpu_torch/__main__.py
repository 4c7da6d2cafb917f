"""`python -m group_attribution_for_diffusion_models_tpu_torch`: list the CLI surface.

Port of the JAX package's ``__main__.py``. Each subcommand runs as
`python -m group_attribution_for_diffusion_models_tpu_torch.cli.<name>` (or
`python -m group_attribution_for_diffusion_models_tpu_torch <name> [args...]`).
"""

import importlib
import pkgutil
import sys

PKG = "group_attribution_for_diffusion_models_tpu_torch"


def _commands():
    from . import cli

    return sorted(info.name for info in pkgutil.iter_modules(cli.__path__)
                  if not info.name.startswith("_") and info.name != "common")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    names = _commands()
    if argv and argv[0] in names:
        return importlib.import_module(f"{PKG}.cli.{argv[0]}").main(argv[1:])
    if argv and argv[0] not in ("-h", "--help"):
        print(f"unknown command {argv[0]!r}\n", file=sys.stderr)
    print(f"usage: python -m {PKG} <command> [args...]\n\ncommands:")
    for n in names:
        doc = ""
        try:
            doc = (importlib.import_module(f"{PKG}.cli.{n}").__doc__ or "").strip().splitlines()[0]
        except Exception:  # a listing line without its summary, as the JAX listing
            pass
        print(f"  {n:32s} {doc}")
    return 0 if not argv or argv[0] in ("-h", "--help") else 2


if __name__ == "__main__":
    # A port CLI's main returns its summary, not an exit status.
    status = main()
    raise SystemExit(status if isinstance(status, int) else 0)
