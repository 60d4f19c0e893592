"""The card tooling's bounds are ``port_bench/counting.py``'s: chip_smoke's
``flash_least_ms`` and ``k8_least_ms`` equal ``counting.flash_least_s`` and
``counting.gaussian_matmul_least_s`` at the tooling's shapes, and
``least_ms`` names the term that sets the bound."""

import pytest

import chip_smoke
from port_bench import counting

# (batch, heads, tokens, head dim): K2 at 336 px, its CLIP shape and a TP
# rank's heads, K9 at 768 px at head dims 64 and 128, K4's attention.
FLASH = ((35, 16, 442, 64), (8, 16, 577, 64), (35, 8, 442, 64),
         (12, 16, 2305, 64), (12, 8, 2305, 128), (4, 3, 145, 64))
# (N, M, C): the exact CRF's message and degree, both Nystrom products.
K8 = ((36864, 36864, 58), (36864, 36864, 1), (2304, 36864, 58),
      (36864, 2304, 58), (36864, 36864, 8))


@pytest.mark.parametrize("b,h,s,d", FLASH)
def test_flash_least_ms_is_counting_flash_least_s(b, h, s, d):
    ms, _ = chip_smoke.flash_least_ms(b, h, s, s, d)
    assert ms == pytest.approx(1e3 * counting.flash_least_s(b, h, s, d),
                               rel=1e-12)


@pytest.mark.parametrize("n,m,c", K8)
def test_k8_least_ms_is_counting_gaussian_matmul_least_s(n, m, c):
    ms, _ = chip_smoke.k8_least_ms(n, m, c)
    assert ms == pytest.approx(
        1e3 * counting.gaussian_matmul_least_s(n, m, c), rel=1e-12)


def test_least_ms_names_the_term_that_sets_it():
    assert chip_smoke.least_ms(counting.HBM_BYTES_PER_S) == (1e3, "bytes")
    assert chip_smoke.least_ms(1.0, counting.BF16_FLOPS) == (1e3, "products")
    assert chip_smoke.least_ms(1.0, 1.0, counting.F32_FLOPS) == \
        (1e3, "element-wise")
    # K2 at 336 px is bound by its bytes, K8's message by its products
    # and its degree by the exponents (port_bench's own tests).
    assert chip_smoke.flash_least_ms(35, 16, 442, 442, 64)[1] == "bytes"
    assert chip_smoke.k8_least_ms(36864, 36864, 58)[1] == "products"
    assert chip_smoke.k8_least_ms(36864, 36864, 1)[1] == "element-wise"
