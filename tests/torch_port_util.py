"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""

import numpy as np


def tree_to_numpy(tree):
    """A JAX params tree → the numpy form `bridge.params_from_numpy` takes:
    arrays become numpy, `QuantizedTensor` leaves become dicts of their fields."""
    from intel_extension_for_transformers_tpu.ops.packing import QuantizedTensor

    if isinstance(tree, QuantizedTensor):
        return {
            "data": np.asarray(tree.data),
            "scales": np.asarray(tree.scales),
            "zeros": None if tree.zeros is None else np.asarray(tree.zeros),
            "pre_scale": None if tree.pre_scale is None else np.asarray(tree.pre_scale),
            "weight_dtype": tree.weight_dtype,
            "scheme": tree.scheme,
            "group_size": tree.group_size,
            "K": tree.K,
            "N": tree.N,
            "layout": tree.layout,
        }
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


def llama_models(jcfg, tcfg, seed=0, group_size=32):
    """A JAX tiny Llama, float, khalf int4 (RTN) and w32, each with the port's
    model carried over by the bridge → {name: (JAX params, port model)}."""
    import jax

    from intel_extension_for_transformers_tpu.models.llama import llama_init_params
    from intel_extension_for_transformers_tpu.ops.packing import prepare_for_inference
    from intel_extension_for_transformers_tpu.quantization import RtnConfig, quantize_model
    from intel_extension_for_transformers_tpu_torch.bridge import llama_from_numpy

    params = llama_init_params(jax.random.PRNGKey(seed), jcfg)
    khalf = quantize_model(params, RtnConfig(weight_dtype="int4", group_size=group_size)).params
    w32 = prepare_for_inference(khalf)
    return {name: (p, llama_from_numpy(tree_to_numpy(p), tcfg, device="cpu"))
            for name, p in (("float", params), ("khalf", khalf), ("w32", w32))}


def index_state(jidx):
    """A JAX FlatIndex → (meta, arrays) for `bridge.flat_index_state`."""
    meta = {
        "dim": jidx.dim, "dtype": jidx.dtype, "metric": jidx.metric, "size": jidx.size,
        "group_size": jidx.group_size, "rotate": jidx.rotate, "center": jidx.center,
        "rescore_dtype": jidx.rescore_dtype, "rotation_seed": jidx.rotation_seed,
        "capacity": jidx._capacity,
    }
    arrays = {}
    if jidx.dtype == "int4":
        arrays["data"] = np.asarray(jidx._data)
        arrays["scales"] = np.asarray(jidx._scales.astype("float32"))
        if jidx._rotation is not None:
            arrays["rotation"] = np.asarray(jidx._rotation)
        if jidx._mean is not None:
            arrays["mean"] = np.asarray(jidx._mean)
        if jidx._shadow is not None:
            arrays["shadow"] = np.asarray(jidx._shadow.astype("float32"))
    else:
        arrays["vectors"] = np.asarray(jidx._vectors.astype("float32"))
    return meta, arrays


def assert_ids_match(ids_a, scores_a, ids_b, scores_b, tol):
    """Row-wise, the two top-k id sets are equal, except for ids whose score
    lies within `tol` of their side's k-th score (a near-tie either side may
    keep)."""
    for ra, va, rb, vb in zip(*map(np.asarray, (ids_a, scores_a, ids_b, scores_b))):
        for own, vals, other in ((ra, va, rb), (rb, vb, ra)):
            kth = vals.min()
            for i, v in zip(own.tolist(), vals.tolist()):
                if i not in other.tolist():
                    assert v <= kth + tol, (ra, va, rb, vb)


def ivf_state(jidx):
    """A JAX IVFIndex → (meta, arrays) as its `save()` writes them, for
    `bridge.ivf_index_state`."""
    import jax.numpy as jnp

    arrays = {
        "centroids": np.asarray(jidx.centroids),
        "storage": np.asarray(jidx._storage.astype(jnp.float32) if jidx._storage.dtype == jnp.bfloat16
                              else jidx._storage),
        "row_ids": np.asarray(jidx._row_ids),
        "fill": np.asarray(jidx._fill),
    }
    if jidx._scales is not None:
        arrays["scales"] = np.asarray(jidx._scales.astype(jnp.float32))
    if jidx._lo is not None:
        arrays["lo"] = np.asarray(jidx._lo)
    meta = {
        "dim": jidx.dim, "n_lists": jidx.n_lists, "metric": jidx.metric, "dtype": jidx.dtype,
        "list_cap": jidx._list_cap, "size": jidx.size, "group_size": jidx.group_size,
        "refine": jidx.refine, "refine_capacity": jidx.refine_capacity,
    }
    return meta, arrays
