from . import cifar10, mnist, reuters

__all__ = ["mnist", "cifar10", "reuters"]
