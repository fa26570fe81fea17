from pde_inverse.models.mlp import PotentialMLP
from pde_inverse.models.parametric import QuadraticFormModel, GMMMeansModel
from pde_inverse.models.factory import get_model
