"""``collections.to_dense_ms`` of the eager cell, which moves ``trial_ms.eager`` (the eager cell's
trial times carry their own bound: the host sets them)."""

from gbbench import registry

read = registry.metric("collections.to_dense_ms").read
