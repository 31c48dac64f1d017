"""The moe family (deepseek-v2-lite): the decoder-only LM of
``transformer.py`` with multi-head latent attention, a first dense layer,
then routed and shared experts."""

from perfbench.reference.transformer import forward_flops, init, last_logits, loss

__all__ = ["init", "loss", "last_logits", "forward_flops"]
