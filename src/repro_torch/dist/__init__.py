"""Distributed substrate: logical-axis sharding over a ``DeviceMesh`` for
the model stack (``repro_torch.models``) and the launch / dry-run drivers.

Counterpart of ``repro/dist``:

``sharding``       — mesh context, activation redistribution, param layouts.
``cache_sharding`` — batch and KV-cache layouts for serving.
``compat``         — ``local_map`` (the ``shard_map`` shim's counterpart).
"""
