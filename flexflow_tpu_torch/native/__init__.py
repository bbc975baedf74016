"""The C model spec's consuming half (counterpart of flexflow_tpu/native/):
`c_model.model_from_spec` builds the port's FFModel from a
`flexflow_tpu_c_model` JSON spec, as a C program exports it through the
C API's ffc_model_export_json.

The ctypes core itself (the JAX package's native/__init__.py over
src/ffcore: the C API, the native search and the dataloader's prefetch
ring) is not ported yet (ROADMAP A11)."""
