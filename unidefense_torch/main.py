"""Training / testing entry point (unidefense_tpu's main.py:16-48):

    python -m unidefense_torch.main --config config_template/forgery/model_udeb4.yml --engine FE
    python -m unidefense_torch.main --config ... --engine FE --test
    python -m unidefense_torch.main --config config_template/ocim/model_udr18.yml --engine OCIM
    python -m unidefense_torch.main --config config_template/uniatt/Prot1/model_udeb4.yml [--test]

    python -m unidefense_torch.main --config ... --engine FE --num_devices 4   # 4 cards
    torchrun --nproc_per_node 4 -m unidefense_torch.main --config ... --engine FE
    torchrun --nnodes 2 --node_rank R --nproc_per_node 8 --rdzv_endpoint HOST:PORT \\
        -m unidefense_torch.main --config ... --engine FE                      # 2 hosts

The same flags as the JAX CLI (--config, --engine {FE,OCIM,UE}, UE by default,
--local_rank/-r, --exp_id, --ds_config, --offline, --test, --num_devices).
It runs on the GPU; without one it stops with ``resolve_device``'s error.
``--num_devices N`` on a plain launch starts N ranks on this host, one per
card (rank r on cuda:r, NCCL, a rendezvous on 127.0.0.1), after building
the kernels once; under ``torchrun`` (``WORLD_SIZE`` in the environment)
this process is one rank of the launcher's world, across hosts too, the
counterpart of the JAX CLI's ``UNIDEFENSE_MULTIHOST=1``.
"""

from __future__ import annotations

import os
import sys

import torch

from unidefense_torch.config import arg_parser, load_config
from unidefense_torch.device import DeviceLike
from unidefense_torch.engines import get_engine
from unidefense_torch.parallel.mesh import check_num_devices, launch


def run(argv, device: DeviceLike = None):
    """One rank (or the one process): train, or with ``--test`` test, and
    return the engine."""
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

    # the engine's own default (the card) unless a device is given
    on = {} if device is None else {"device": device}
    engine = get_engine(arg.engine)(config, stage="Test" if arg.test else "Train", **on)
    if arg.test:
        engine.test()
    else:
        engine.train()
    return engine


def main(argv=None, device: DeviceLike = None):
    """Train, or with ``--test`` test, on ``device`` (None: the card; the
    tests pass ``"cpu"``, whose ranks meet over gloo). Returns the engine,
    or None where ``--num_devices`` above 1 spawned the ranks (it returns
    when they all have; if one fails, the others are terminated and the
    failure is raised)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    arg = arg_parser(argv)
    if arg.num_devices is not None and arg.num_devices > 1 and "WORLD_SIZE" not in os.environ:
        from unidefense_torch.ops import _build

        check_num_devices(arg.num_devices, device)
        # built once here, not raced by the ranks
        _build.host_library()
        if torch.device(device or "cuda").type == "cuda" and torch.cuda.is_available():
            _build.build_all()
        launch(run, arg.num_devices, args=(argv, device), device=device)
        return None
    return run(argv, device)


if __name__ == "__main__":
    main(sys.argv[1:])
