from pde_inverse.losses import fokker_planck
from pde_inverse.losses import kinetic_fokker_planck
from pde_inverse.losses import kinetic_mckean_vlasov

LOSS_MODULES = {
    "Fokker-Planck": fokker_planck,
    "Kinetic-Fokker-Planck": kinetic_fokker_planck,
    "Kinetic-McKean-Vlasov": kinetic_mckean_vlasov,
}
