"""Host-side I/O: dataset runners, message schema, pub/sub, checkpoints."""
