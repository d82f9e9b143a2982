"""tabla-paper: the paper's own set of experiment cells, not an architecture.

The (function, interval, E_a, formats) cells of the paper's Fig. 3, Figs. 4-5
and Tables 2/3, consumed by ``launch/paper.py``, ``examples/quickstart_torch.py``
and ``chip_smoke.py``.  It defines no ``CONFIG``, and ``models/registry.py``
does not offer it as an ``--arch``.  The port's copy of the JAX package's
``configs/tabla_paper.py``."""

from repro_torch.core.quantize import PAPER_FORMATS

E_A_TABLE2 = 9.5367e-07  # Sec. 5.4 / Table 2 sweep error bound
E_A_FIG3 = 1.25e-4
E_A_WORKED = 1.22e-4  # Sec. 5.1-5.3 worked examples

# Table 2 functions with their intervals (the sweep benchmark set)
TABLE2_CELLS = {
    "log": (0.625, 15.625),
    "exp": (0.0, 5.0),
    "tan": (-1.5, 0.0),
    "tanh": (-8.0, 0.0),
    "sigmoid": (-10.0, 0.0),
    "gauss": (-6.0, 0.0),
}

# Table 3 synthesis cells (wider, both-signed intervals)
TABLE3_CELLS = {
    "tan": (-1.5, 1.5),
    "log": (0.625, 15.625),
    "exp": (0.0, 5.0),
    "tanh": (-8.0, 8.0),
    "gauss": (-6.0, 6.0),
    "sigmoid": (-10.0, 10.0),
}

FORMATS = PAPER_FORMATS
OMEGA_SWEEP = [round(0.01 * i, 2) for i in range(1, 31)]  # Fig. 6 x-axis
