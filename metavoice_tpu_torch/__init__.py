"""PyTorch + CUDA port of metavoice_tpu (the JAX/Pallas TTS framework).

Runs the default bf16 ``TTS.synthesise`` path; the T=1 decode attention is a
hand-written CUDA kernel for Hopper (``csrc/decode_attention.cu``). The
package imports ``torch``, numpy and scipy, and nothing of JAX or of
``metavoice_tpu``: entry point ``metavoice_tpu_torch.runtime.tts.TTS``.
"""
