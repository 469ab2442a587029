# SPDX-License-Identifier: Apache-2.0
"""Math building blocks shared by the kernel modules.

JAX counterpart of ``nvalchemiops/math`` (reference: math/math.py,
math/spherical_harmonics.py, math/gto.py).  The Warp device functions become
plain jnp functions — usable both in traced XLA code and inside Pallas kernel
bodies (which accept jnp expressions directly).
"""

from nvalchemiops_tpu.mathops.math import (  # noqa: F401
    apply_mat3,
    divmod_floor,
    dot_phases,
    erfc_approx,
    exp_over_x,
    safe_divide,
    sinc_normalized,
)
from nvalchemiops_tpu.mathops import spherical_harmonics as _sh_mod
from nvalchemiops_tpu.mathops.spherical_harmonics import (  # noqa: F401
    eval_all_spherical_harmonics,
    eval_spherical_harmonics_l0,
    eval_spherical_harmonics_l1,
    eval_spherical_harmonics_l2,
    spherical_harmonics,
    spherical_harmonics_gradient,
)
from nvalchemiops_tpu.mathops.gto import (  # noqa: F401
    eval_gto_density,
    eval_gto_fourier,
    gto_density_all,
    gto_density_l0,
    gto_density_l0_gradient,
    gto_density_l1,
    gto_density_l2,
    gto_fourier_l0,
    gto_fourier_l1_imag,
    gto_fourier_l1_real,
    gto_fourier_l2_real,
    gto_gaussian_factor,
    gto_integral_l0,
    gto_normalization,
    gto_self_overlap,
)

# per-component harmonic accessors (spherical_harmonic_00 ... _2p2[_gradient])
_SH_COMPONENT_FNS = []
for _n in _sh_mod._COMPONENT_NAMES:
    for _suffix in ("", "_gradient"):
        _fn_name = f"spherical_harmonic_{_n}{_suffix}"
        globals()[_fn_name] = getattr(_sh_mod, _fn_name)
        _SH_COMPONENT_FNS.append(_fn_name)
del _sh_mod, _n, _suffix, _fn_name

__all__ = [
    "apply_mat3",
    "divmod_floor",
    "dot_phases",
    "erfc_approx",
    "exp_over_x",
    "safe_divide",
    "sinc_normalized",
    "spherical_harmonics",
    "spherical_harmonics_gradient",
    "eval_all_spherical_harmonics",
    "eval_spherical_harmonics_l0",
    "eval_spherical_harmonics_l1",
    "eval_spherical_harmonics_l2",
    "eval_gto_density",
    "eval_gto_fourier",
    "gto_density_all",
    "gto_density_l0",
    "gto_density_l0_gradient",
    "gto_density_l1",
    "gto_density_l2",
    "gto_fourier_l0",
    "gto_fourier_l1_imag",
    "gto_fourier_l1_real",
    "gto_fourier_l2_real",
    "gto_gaussian_factor",
    "gto_integral_l0",
    "gto_normalization",
    "gto_self_overlap",
] + _SH_COMPONENT_FNS
