"""K1-K4 plain versions on G2 (Fq2) against the JAX package's eager
`ec_pallas` entry points and pyref: the checks of test_torch_ec.py."""

import pytest

from test_torch_ec import check_map_padd, check_map_pdouble, check_scan_mixed, check_scan_proj


def test_map_padd_vs_jax_g2():
    check_map_padd("g2")


@pytest.mark.parametrize("times", [1, 3])
def test_map_pdouble_vs_jax_g2(times):
    check_map_pdouble("g2", times)


def test_scan_mixed_vs_jax_g2():
    check_scan_mixed("g2")


def test_scan_proj_vs_jax_g2():
    check_scan_proj("g2")
