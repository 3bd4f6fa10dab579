from .checkpoint import load_checkpoint, save_checkpoint
from .optim import SSNOptimizer, make_optimizer
from .trainer import (LossWeights, batch_to_device, make_loss_fn,
                      make_train_step)
