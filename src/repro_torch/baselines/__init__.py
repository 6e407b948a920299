"""Matrix-factorization baselines of the paper's Table 2 (port of
``repro.baselines``): ALS (``als``), CCD++ (``ccd``) and FPSGD-style
blocked SGD (``sgd``). Each ``run_*`` takes an int seed or a batch-1 noise
source for its initial factors and returns (U, V, test predictions).
"""
from repro_torch.baselines.als import ALSConfig, run_als      # noqa: F401
from repro_torch.baselines.ccd import CCDConfig, run_ccd      # noqa: F401
from repro_torch.baselines.sgd import SGDConfig, run_sgd      # noqa: F401
