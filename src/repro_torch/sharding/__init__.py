"""The LM substrate's mesh (counterpart of ``repro.sharding``): the
partition rules and placement (``partition``) and the collectives with
their gradient rules (``comm``). The reference's ``compat`` (a
``shard_map`` version shim) has no counterpart: nothing here calls
``shard_map``."""
