from repro_torch.analysis.plancheck import (  # noqa: F401
    RULES, PlanCheckReport, check_decode_tick, check_plan)
