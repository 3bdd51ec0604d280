from .differential import PERTURBATIONS, apply_perturbation
from .harness import run_ad, run_fd, run_orig
