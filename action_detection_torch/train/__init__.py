from .checkpoint import checkpoint_name, load_checkpoint, save_checkpoint
from .optim import SSNOptimizer, make_optimizer
from .trainer import (LossWeights, batch_to_device, float32_convs_and_matmuls,
                      make_binary_loss_fn, make_eval_step, make_loss_fn,
                      make_train_step)
