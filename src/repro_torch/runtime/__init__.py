"""The LM substrate's training loop (counterpart of ``repro.runtime``; the
elastic re-mesh comes with the mesh slice)."""
