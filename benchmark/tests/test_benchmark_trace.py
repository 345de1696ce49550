"""The trace reduction on a synthetic trace: busy time as the union of
device intervals, the warp kernels by name, idle gaps filed by span."""

from harness.trace import KERNEL_MAP, Trace


def test_union_kernels_and_gaps():
    ops = [("void splat_kernel<4, true>(float const*)", 0, 10),
           ("sm90_xmma_fprop_implicit_gemm", 5, 20),
           ("void row_gather_kernel<float2>(float2 const*)", 40, 50),
           ("void gather_fused_kernel<4, true, false>(float const*)", 60,
            61)]
    spans = [("bench.step", 0, 55), ("bench.loss_readback", 55, 100)]
    tr = Trace(0.0000001, ops, spans, 0, 100)
    assert abs(tr.busy_s - 31e-9) < 1e-15
    assert abs(tr.kernel_s("warp") - 21e-9) < 1e-15
    gaps = dict(tr.idle_gaps())
    assert abs(gaps["step"] - 20e-9) < 1e-15  # 20..40
    assert abs(gaps["loss_readback"] - 49e-9) < 1e-15  # 50..60, 61..100
    assert tr.device_ops()[0][0].startswith("sm90")


def test_kernel_map_names():
    pat = KERNEL_MAP["warp"]
    for name in ("void splat_scan_kernel<4>(float const*, int, unsigned*)",
                 "void splat_finish_kernel<2, false>(long long const*)",
                 "void gather_kernel<2, true>(float const*)",
                 "void gather_fused_kernel<4, true, true>(float const*)",
                 "void row_gather_kernel<float2>(float2 const*)"):
        assert pat.search(name), name
    for name in ("sm80_xmma_dgrad_implicit_gemm_f32f32",
                 "void at::native::index_elementwise_kernel<128, 4>",
                 "void at::native::upsample_bilinear2d_out_frame<float>",
                 "grid_sampler_2d_kernel"):
        assert not pat.search(name), name
