"""PyTorch/CUDA port of minimax_speech_tpu.

Module names mirror the JAX package (``models/flow.py`` here is the
counterpart of ``minimax_speech_tpu/models/flow.py``), public functions
keep its layouts (channel-last (B, T, C), attention (B, H, T, D)), and
weights cross over through ``utils.params_io.load_flax_params``. The
package imports torch, numpy and the standard library only; the JAX
package stays the reference it is tested against.
"""
