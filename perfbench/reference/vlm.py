"""The vlm family (phi-3-vision): the decoder-only LM of ``transformer.py``
with image embeddings ahead of the text; the loss counts the text only."""

from perfbench.reference.transformer import forward_flops, init, last_logits, loss

__all__ = ["init", "loss", "last_logits", "forward_flops"]
