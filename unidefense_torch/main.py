"""Training / testing entry point (unidefense_tpu's main.py:16-48):

    python -m unidefense_torch.main --config config_template/forgery/model_udeb4.yml --engine FE
    python -m unidefense_torch.main --config ... --engine FE --test

The same flags as the JAX CLI (--config, --engine {FE,OCIM,UE},
--local_rank/-r, --exp_id, --ds_config, --offline, --test, --num_devices).
It runs on the GPU; without one it stops with ``resolve_device``'s error.
"""

from __future__ import annotations

import sys

from unidefense_torch.config import arg_parser, load_config
from unidefense_torch.engines import get_engine


def main(argv=None):
    """Train, or with ``--test`` test, and return the engine."""
    arg = arg_parser(argv)
    config = load_config(
        arg.config,
        engine=arg.engine,
        local_rank=arg.local_rank,
        exp_id=arg.exp_id,
        ds_config=arg.ds_config,
    )
    config["config"]["offline"] = arg.offline
    if arg.num_devices is not None:
        config["config"]["num_devices"] = arg.num_devices

    engine = get_engine(arg.engine)(config, stage="Test" if arg.test else "Train")
    if arg.test:
        engine.test()
    else:
        engine.train()
    return engine


if __name__ == "__main__":
    main(sys.argv[1:])
