"""The LM substrate's training loop and its elastic re-mesh (counterpart
of ``repro.runtime``)."""
