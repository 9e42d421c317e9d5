"""The optimizer of the LM substrate (counterpart of ``repro.optim``)."""
