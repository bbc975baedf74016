"""The plain references: plain torch in float32 with TF32 off, one file a
configuration, importing nothing of the port."""
