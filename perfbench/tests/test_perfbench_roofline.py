"""The roofline's count, against a batch worked by hand."""

from perfbench.roofline import model


def test_msm_additions_by_hand():
    # 1 signature: c = 2 gives 64 windows of 1 point over R's 128 bits and
    # 127 windows of 2 points (A, B) and 4 bucket additions: 64 + 762 = 826,
    # below c = 1 (1140) and c = 3 (893).
    assert model.msm_additions(1) == 826
    # 2 signatures: c = 2, 64 * 2 + 127 * (3 + 4) = 1017, below c = 3 (1021).
    assert model.msm_additions(2) == 1017
    assert model.msm_additions(0) == 0


def test_one_signature_batch_by_hand():
    # R's decompression 19 M + 255 S; 826 additions of 7 M; 253 + 3
    # doublings of 3 M + 4 S.
    assert model.batch_field_ops(1) == (19 + 7 * 826 + 3 * 256, 255 + 4 * 256) == (6569, 1279)
    # 144 multiply-adds a multiplication (64 products and 8 by 38, two
    # each), 88 a squaring (36 products and the same 8).
    assert (model.FIELD_MUL_MADDS, model.FIELD_SQR_MADDS) == (144, 88)
    assert model.batch_madds(1) == 6569 * 144 + 1279 * 88 == 1058488
    assert model.batch_bytes(1, 1) == 64 + 32 + 64 + 1
    t, bound = model.least_seconds([(1, 1)], sms=132, clock_mhz=1980.0)
    assert bound == "int32 multiply-adds"
    assert abs(t - 1058488 / (64 * 132 * 1980e6)) < 1e-18


def test_work_grows_with_the_batch_and_not_with_any_kernel_geometry():
    w = [model.batch_madds(n) for n in (67, 673, 5336)]
    assert w[0] < w[1] < w[2]
    # Per signature the bucket method gets cheaper as batches grow.
    assert w[2] / 5336 < w[1] / 673 < w[0] / 67
