"""The GF(256) decode step of vega_tpu_torch against vega_tpu, on the CPU.

kernels.gf256_accumulate computes out = XOR_i c_i * B_i over GF(256) for
uint8 byte rows B [n, L] and coefficients c [n]; it must be bit-identical
to the reference's numpy twin (shuffle/coding._accumulate_np) and to its
jnp function (tpu/kernels.gf256_accumulate), for the XOR scheme's
all-ones coefficients, the RS Cauchy coefficients and masked (zero)
members, at the reference's shapes and at the k <= 128 clamp.
"""

import numpy as np
import pytest
import torch

from vega_tpu_torch import kernels

SHAPES = [(1, 17), (4, 256), (7, 1023), (128, 300), (5, 1)]
SCHEMES = ["xor", "rs", "masked"]


def _coeffs(scheme, n):
    from vega_tpu.shuffle import coding

    if scheme == "xor":
        return np.ones(n, dtype=np.uint8)
    if scheme == "rs":
        return np.array([coding.coeff("rs", 0, i) for i in range(n)],
                        dtype=np.uint8)
    return np.array([(0 if i % 2 else 143) for i in range(n)],
                    dtype=np.uint8)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_matches_reference(shape, scheme):
    from vega_tpu.shuffle import coding
    from vega_tpu.tpu.kernels import gf256_accumulate as ref_accumulate

    n, width = shape
    rng = np.random.RandomState(11 + n)
    blocks = rng.randint(0, 256, size=(n, width)).astype(np.uint8)
    coeffs = _coeffs(scheme, n)
    want = coding._accumulate_np(blocks, coeffs)
    np.testing.assert_array_equal(
        np.asarray(ref_accumulate(blocks, coeffs), dtype=np.uint8), want)
    got = kernels.gf256_accumulate(blocks, coeffs, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (width,)
    np.testing.assert_array_equal(got.numpy(), want)
    # tensor inputs run where they lie
    again = kernels.gf256_accumulate(torch.from_numpy(blocks),
                                     torch.from_numpy(coeffs))
    np.testing.assert_array_equal(again.numpy(), want)


def test_tables_match_reference():
    from vega_tpu.shuffle import coding

    np.testing.assert_array_equal(kernels.GF_EXP, coding.GF_EXP)
    np.testing.assert_array_equal(kernels.GF_LOG, coding.GF_LOG)
    assert kernels.GF_EXP.dtype == np.uint8 and kernels.GF_EXP.shape == (512,)


def test_every_product_matches_gf_mul():
    """All 65,536 products c * b: one member b = 0..255 per coefficient."""
    from vega_tpu.shuffle import coding

    row = np.arange(256, dtype=np.uint8)[None, :]
    for c in range(256):
        got = kernels.gf256_accumulate(row, np.array([c], np.uint8),
                                       device="cpu")
        assert got.tolist() == [coding.gf_mul(c, b) for b in range(256)], c


def test_tiles_do_not_change_the_result(monkeypatch):
    """Column tiles smaller than a row, and not dividing it, give the
    same bytes."""
    from vega_tpu.shuffle import coding

    rng = np.random.RandomState(2)
    blocks = rng.randint(0, 256, size=(9, 1000)).astype(np.uint8)
    coeffs = rng.randint(0, 256, size=9).astype(np.uint8)
    monkeypatch.setattr(kernels, "_GF_TILE", 9 * 37)
    got = kernels.gf256_accumulate(blocks, coeffs, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  coding._accumulate_np(blocks, coeffs))


def test_xor_scheme_recovers_a_lost_member():
    """XOR parity over a group of 4, then parity XOR the three survivors
    gives the lost member back."""
    rng = np.random.RandomState(5)
    members = rng.randint(0, 256, size=(4, 4096)).astype(np.uint8)
    parity = kernels.gf256_accumulate(members, np.ones(4, np.uint8),
                                      device="cpu")
    for lost in range(4):
        survivors = np.concatenate([members[:lost], members[lost + 1:],
                                    parity.numpy()[None, :]])
        back = kernels.gf256_accumulate(survivors, np.ones(4, np.uint8),
                                        device="cpu")
        np.testing.assert_array_equal(back.numpy(), members[lost])


def test_rs_scheme_recovers_one_lost_member():
    """One RS parity unit: p = XOR c_i B_i, so a lost member j is
    c_j^-1 * (p XOR (XOR_{i != j} c_i B_i))."""
    from vega_tpu.shuffle import coding

    rng = np.random.RandomState(6)
    members = rng.randint(0, 256, size=(5, 1000)).astype(np.uint8)
    coeffs = _coeffs("rs", 5)
    parity = kernels.gf256_accumulate(members, coeffs, device="cpu").numpy()
    lost = 3
    rest = [i for i in range(5) if i != lost]
    partial = kernels.gf256_accumulate(
        np.concatenate([members[rest], parity[None, :]]),
        np.concatenate([coeffs[rest], [1]]).astype(np.uint8),
        device="cpu").numpy()
    inv = coding.gf_inv(int(coeffs[lost]))
    back = kernels.gf256_accumulate(partial[None, :],
                                    np.array([inv], np.uint8), device="cpu")
    np.testing.assert_array_equal(back.numpy(), members[lost])


def test_empty_group_and_bad_shapes():
    out = kernels.gf256_accumulate(np.zeros((0, 7), np.uint8),
                                   np.zeros(0, np.uint8), device="cpu")
    assert out.tolist() == [0] * 7
    with pytest.raises(kernels.VegaError):
        kernels.gf256_accumulate(np.zeros((3, 7), np.uint8),
                                 np.ones(2, np.uint8), device="cpu")


def test_numpy_input_without_a_device_needs_the_card():
    """Numpy input goes to the card unless the caller asks for the CPU."""
    blocks = np.ones((2, 4), np.uint8)
    if torch.cuda.is_available():
        out = kernels.gf256_accumulate(blocks, np.ones(2, np.uint8))
        assert out.device.type == "cuda"
    else:
        with pytest.raises(kernels.VegaError, match="device='cpu'"):
            kernels.gf256_accumulate(blocks, np.ones(2, np.uint8))
