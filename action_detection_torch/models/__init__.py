from .ssn import SSN, fuse_test_heads
from .binary import BinaryClassifier
from .backbones import get_backbone, InputSpec
from .convert import (jax_from_state_dict, quantized_from_jax, seeded_init,
                      state_dict_from_jax)
