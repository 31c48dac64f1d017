"""The plain reference that decides whether a run is correct.

Plain PyTorch in float32 with TF32 off, written out from the published
layer equations as the port runs them (frozen here, so that a later change
to ``repro_torch`` cannot move the yardstick). It imports neither JAX, nor
the JAX package, nor anything of ``repro_torch``. ``<arch_type>.py`` holds
one model family (``init``, ``loss``, ``last_logits``); ``mmfl.py`` holds
the round: the alpha-fair allocation, the batches, the local SGD steps,
the fold and the AdamW server step.
"""
