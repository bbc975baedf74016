"""Op implementations; importing this package registers every op type."""
from . import (attention, conv, core_ops, elementwise,  # noqa: F401
               embedding, linear, moe, norm, rnn, tensor_ops)
