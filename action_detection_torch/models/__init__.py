from .ssn import SSN, fuse_test_heads
from .backbones import get_backbone, InputSpec
from .convert import quantized_from_jax, seeded_init, state_dict_from_jax
