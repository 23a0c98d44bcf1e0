from unidefense_torch.utils.io import load_from_json, write_to_json
from unidefense_torch.utils.meters import AverageMeter, Timer
from unidefense_torch.utils.metrics import cal_metrics, find_best_threshold, get_tpr_at_fpr

__all__ = [
    "cal_metrics",
    "find_best_threshold",
    "get_tpr_at_fpr",
    "AverageMeter",
    "Timer",
    "load_from_json",
    "write_to_json",
]
