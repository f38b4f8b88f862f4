from repro_torch.models.model import (decode_multi, decode_step,
                                      decode_step_paged, forward_mtp,
                                      forward_train, init_params,
                                      init_state, prefill, prefill_batched,
                                      prefill_chunk)

__all__ = ["init_params", "forward_train", "forward_mtp", "init_state",
           "prefill", "prefill_batched", "prefill_chunk", "decode_step",
           "decode_step_paged", "decode_multi"]
