from .synthetic import (
    generate_anisotropic_gmm as generate_anisotropic_gmm,
    generate_dataset as generate_dataset,
    generate_gmm_1d as generate_gmm_1d,
)
