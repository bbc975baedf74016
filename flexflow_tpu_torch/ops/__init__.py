"""Op implementations; importing this package registers every op type."""
from . import (attention, core_ops, elementwise, embedding,  # noqa: F401
               linear, norm, tensor_ops)
