"""Architecture configs."""
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS, LoweringPlan, all_pairs, get_config, get_smoke_config,
    lowering_plan)
