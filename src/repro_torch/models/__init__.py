from repro_torch.models.model import (decode_multi, decode_step,
                                      decode_step_paged, init_params,
                                      init_state, prefill, prefill_batched,
                                      prefill_chunk)

__all__ = ["init_params", "init_state", "prefill", "prefill_batched",
           "prefill_chunk", "decode_step", "decode_step_paged",
           "decode_multi"]
