"""Physical constants.

Capability parity: reference ``constants.py:2`` (speed of light).
"""

c: float = 299_792_458.0  # vacuum speed of light [m/s]

hbar: float = 1.054_571_817e-34  # reduced Planck constant [J s] (CODATA 2018)

TWO_PI: float = 6.283185307179586476925286766559  # 2*pi
