"""Op implementations; importing this package registers every op type."""
from . import attention, core_ops, elementwise, embedding, linear, norm  # noqa: F401
