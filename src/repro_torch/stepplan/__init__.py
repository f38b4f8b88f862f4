"""Step-plan layer: the plan records and the planner that compiles a
scheduling iteration's declarative actions into them.

A copy of the JAX package's ``repro.stepplan``, held against it by
``tests/test_torch_scheduling.py`` (equal plan traces).  Where the copy's
comments speak of jitted shapes or of the simulator, they describe the
JAX package's backends; the port's live engine runs the same plans.
"""
from repro_torch.stepplan.planner import Planner
from repro_torch.stepplan.plans import (DecodePlan, MixedPlan, PlanError,
                                        PrefillItem, PrefillPlan, StepPlan,
                                        TransferPlan, bucket_len, decode_part,
                                        prefill_part)

__all__ = ["Planner", "PlanError", "StepPlan", "PrefillItem", "PrefillPlan",
           "DecodePlan", "MixedPlan", "TransferPlan", "bucket_len",
           "prefill_part", "decode_part"]
