"""Config-parse smoke test: ``load_config()`` (the default config.yaml,
or ``$PDM_CONFIG``), then ``config OK: experiment=...``.

Counterpart of ``scripts/check_config.py``. ``--device`` as every entry
point of the port (the card by default, raising without one; ``cpu``
otherwise), though the check itself runs on the host.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..config.config import Config
from ..config.loader import load_config
from ..core.device import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> Config:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    resolve_device(parser.parse_args(argv).device)
    config = load_config()
    print(f"config OK: experiment={config.experiment_name}")
    return config


if __name__ == "__main__":
    main()
