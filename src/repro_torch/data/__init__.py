"""The LM substrate's synthetic data stream (counterpart of
``repro.data``)."""
