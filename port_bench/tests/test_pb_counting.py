"""The yardstick's counts at the main shapes, against numbers worked by
hand."""

import pytest

from port_bench import counting

VIT = dict(patch_size=16, hidden_size=1024, num_layers=24, mlp_ratio=4.0)
BERT = dict(hidden_size=768, encoder_width=1024, intermediate_size=3072,
            num_layers=12)


def test_vit_flops_at_442_tokens():
    # patch conv 2*441*768*1024 = 693,633,024; a block
    # 2*442*1024*(3072 + 1024 + 8192) + 4*442^2*1024 = 11,923,505,152.
    want = 693_633_024 + 24 * 11_923_505_152
    assert counting.vit_flops(dict(VIT, image_size=336)) == want
    assert want == 286_857_756_672


def test_vit_flops_at_2305_tokens():
    # patch conv 2*2304*768*1024; a block 2*2305*1024*12288
    # + 4*2305^2*1024 = 79,769,374,720.
    want = 3_623_878_656 + 24 * 79_769_374_720
    assert counting.vit_flops(dict(VIT, image_size=768)) == want


def test_bert_forward_and_tap_backward_at_336_px():
    # Forward a layer: self 314,572,800 + cross 1,628,307,456 (of it the
    # image tokens' K/V 1,390,411,776) + FFN 603,979,776; backward: four
    # layers above the tap at 1,169,031,168, the tap layer 722,927,616.
    want = 12 * 2_546_860_032 + 4 * 1_169_031_168 + 722_927_616
    assert counting.bert_flops(BERT, 442, 64, 7) == want == 35_961_372_672


def test_model_flops_per_image_counts_every_round():
    model = {"vit": dict(VIT, image_size=336), "bert": BERT}
    pipe = {"attribution": {"layer": 8}, "drop": {"num_rounds": 4}}
    assert counting.model_flops_per_image(model, pipe, 64) == \
        4 * (286_857_756_672 + 35_961_372_672)


def test_flash_bound_at_k2_is_its_bytes():
    # qkv [35, 442, 3072] + out [35, 442, 1024] bf16 = 126,730,240 B.
    assert counting.flash_least_s(35, 16, 442, 64) == \
        pytest.approx(126_730_240 / 3.35e12, rel=1e-12)


def test_flash_bound_at_k4_is_its_products():
    # 4 * 12*16*2305^2 * 64 = 261,145,804,800 FLOP at 989 TFLOP/s.
    assert counting.flash_least_s(12, 16, 2305, 64) == \
        pytest.approx(261_145_804_800 / 989e12, rel=1e-12)


def test_k8_bound_at_the_exact_crf():
    pairs = 36864 ** 2  # 1,358,954,496
    # A message over all 58 slots: 2 * pairs * (5 + 58) products; the
    # degree (one channel): one exponent a pair on the CUDA cores.
    assert counting.gaussian_matmul_least_s(36864, 36864, 58) == \
        pytest.approx(2 * pairs * 63 / 989e12, rel=1e-12)
    assert counting.gaussian_matmul_least_s(36864, 36864, 1) == \
        pytest.approx(pairs / 67e12, rel=1e-12)


@pytest.mark.parametrize("classes, seconds", [
    # One class and the background, both variants: 4 live channels; a
    # message 2 * pairs * 9 = 24,461,180,928 products, 24.734 us, over the
    # exponents' 20.283 us; the degree 20.283 us.
    (1, 1_358_954_496 / 67e12 + 10 * 24_461_180_928 / 989e12),
    # Four classes: 10 live channels, 2 * pairs * 15 = 40,768,634,880
    # products a message, 41.222 us.
    (4, 1_358_954_496 / 67e12 + 10 * 40_768_634_880 / 989e12),
])
def test_k8_image_counts_the_live_channels(classes, seconds):
    live = 2 * (classes + 1)
    assert counting.crf_image_least_s(36864, 36864, 10, live) == \
        pytest.approx(seconds, rel=1e-12)
