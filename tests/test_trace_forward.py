"""trace_forward.py's trace reading and summary on the CPU, and its refusal
to run without a GPU."""

import jax
import jax.numpy as jnp
import pytest

import trace_forward as tf


@pytest.mark.parametrize("name,cls", [
    ("sm90_xmma_gemm_i8i32_i8i32_i32_tn_n_tilesize128x256x64_cublas",
     "int8 GEMM, cuBLAS"),
    ("nvjet_tss_208x64_64x6_1x1_h_bz_TNN", "bf16 GEMM, cuBLAS"),
    ("gemm_fusion_dot_general_79", "GEMM fusion, Triton"),
    ("input_transpose_fusion_12", "transpose"),
    ("Memset 0", "memset/memcpy"),
    ("loop_convert_fusion", "elementwise/reduce fusion"),
])
def test_kernel_class(name, cls):
    assert tf.kernel_class(name) == cls


def test_summarize_window_counts_busy_span_idle_and_scopes():
    kernels = [  # (name, start, end, stats) in ns
        ("gemm_fusion_dot_1", 1000, 3000, {"name": "jit(f)/attn"}),
        ("loop_convert_fusion", 2000, 4000, {"name": "jit(f)/mlp"}),
        ("nvjet_x", 6000, 7000, {}),
        ("loop_convert_fusion", 50_000, 51_000, {}),   # outside the window
    ]
    s = tf.summarize_window((0, 10_000), kernels)
    assert s["n_kernels"] == 3
    assert s["device_span_us"] == 6.0           # 1000 .. 7000 ns
    assert s["busy_us"] == 4.0                  # 1000-4000 and 6000-7000
    assert s["kernel_sum_us"] == 5.0
    assert s["idle_share_of_span"] == pytest.approx(1 / 3)
    assert s["by_class_us"] == {"GEMM fusion, Triton": 2.0,
                                "elementwise/reduce fusion": 2.0,
                                "bf16 GEMM, cuBLAS": 1.0}
    assert s["by_scope_us"] == {"attn": 2.0, "mlp": 2.0, "unattributed": 1.0}


def test_read_trace_finds_the_host_windows(tmp_path):
    f = jax.jit(lambda x: x @ x)
    x = jnp.ones((64, 64))
    jax.block_until_ready(f(x))
    jax.profiler.start_trace(str(tmp_path))
    for _ in range(2):
        with jax.profiler.TraceAnnotation("fwd_test"):
            jax.block_until_ready(f(x))
    jax.profiler.stop_trace()
    path = next(tmp_path.rglob("*.xplane.pb"))
    windows, _ = tf.read_trace(str(path))
    assert len(windows["fwd_test"]) == 2
    assert all(s < e for s, e in windows["fwd_test"])


def test_main_refuses_a_non_gpu_platform(capsys):
    with pytest.raises(SystemExit) as e:
        tf.main([])
    assert "needs a GPU" in str(e.value)
    assert capsys.readouterr().out == ""
