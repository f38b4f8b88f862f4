from repro_torch.stepplan.plans import (DecodePlan, PrefillItem, PrefillPlan,
                                        bucket_len)

__all__ = ["DecodePlan", "PrefillItem", "PrefillPlan", "bucket_len"]
