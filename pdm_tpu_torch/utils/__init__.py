from .synthetic import (
    generate_anisotropic_gmm as generate_anisotropic_gmm,
    generate_gmm_1d as generate_gmm_1d,
)
