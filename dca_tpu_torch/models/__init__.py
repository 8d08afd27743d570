from . import core
from .network import (
    AE_types,
    Autoencoder,
    NBAutoencoder,
    NBConstantDispAutoencoder,
    NBForkAutoencoder,
    NBSharedAutoencoder,
    PoissonAutoencoder,
    ZINBAutoencoder,
    ZINBAutoencoderElemPi,
    ZINBConstantDispAutoencoder,
    ZINBForkAutoencoder,
    ZINBSharedAutoencoder,
    get_ae_type,
)

__all__ = [
    "AE_types",
    "core",
    "get_ae_type",
    "Autoencoder",
    "PoissonAutoencoder",
    "NBConstantDispAutoencoder",
    "NBAutoencoder",
    "NBSharedAutoencoder",
    "NBForkAutoencoder",
    "ZINBAutoencoder",
    "ZINBAutoencoderElemPi",
    "ZINBSharedAutoencoder",
    "ZINBForkAutoencoder",
    "ZINBConstantDispAutoencoder",
]
