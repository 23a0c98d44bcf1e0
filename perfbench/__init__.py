"""The benchmark of the PyTorch and CUDA port (``unidefense_torch``); run
``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout."""
