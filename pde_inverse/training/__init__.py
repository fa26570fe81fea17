from pde_inverse.training.optimizers import get_optimizer
from pde_inverse.training.trainer import Trainer
