"""Generate tests/data/torch_production_reference.json: the JAX package's
result for the production-census protocol that chip_smoke.py drives in the
PyTorch port.

The protocol and the limit rule are those of make_torch_slice_reference.py
(headline model, spectral init, 300 sweeps with the first 200 annealed from
beta 0.1, 64 chains on the CPU); the sweep is the bench's production census
(bench.py:71-77, :162-167):

    sweep_full(collapsed_z=True, gauge=True, p_indep=0.3,
               phi_mala_steps=4, phi_mala_step=0.05)

Run (a few minutes):

    JAX_PLATFORMS=cpu python tests/data/make_torch_production_reference.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import make_torch_slice_reference as slice_ref  # noqa: E402

CENSUS = dict(collapsed_z=True, gauge=True, p_indep=0.3, phi_mala_steps=4,
              phi_mala_step=0.05)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_production_reference.json")

if __name__ == "__main__":
    slice_ref.main(CENSUS, OUT)
