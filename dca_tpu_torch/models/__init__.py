from . import core
from .network import AE_types, Autoencoder, NBAutoencoder, get_ae_type

__all__ = ["AE_types", "Autoencoder", "NBAutoencoder", "core", "get_ae_type"]
