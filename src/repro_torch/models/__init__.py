"""The model stack of the port, trimmed to the dense serve path: layers,
attention, the decoder-only transformer, the family registry and the
conversion of the reference's parameters."""
