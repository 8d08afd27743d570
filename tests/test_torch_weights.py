"""Saved and loaded weights and models of the port
(``dca_tpu_torch/models/network.py``: ``save_weights``, ``load_weights``,
``load_model``) against the JAX package's on the CPU.

``weights.hdf5`` crosses both ways: the port's flat file through the JAX
package's ``load_weights`` and the JAX package's through the port's; a
reference Keras ``weights.hdf5`` (built here the way
``tests/test_keras_interop.py`` builds it: root attribute ``layer_names``,
per-layer ``weight_names``) loads into every architecture of ``AE_types``
and gives the forward of a network carrying those weights, in both
packages.  The forward outputs of the loaded networks agree with the JAX
package's within 1e-5 (float32 matmuls of two libraries, summed in
another order); within the port a load gives the writer's bits.
``model.pickle`` of the JAX package and a reference stub pickle rebuild
the network.  A load copies into the module's tensors in place, so their
addresses (which a captured CUDA graph reads) do not move.
"""

import pickle
import sys
import types

import numpy as np
import pytest
import torch

from dca_tpu.models import AE_types as JAE
from dca_tpu.models import core as jcore
from dca_tpu.models.network import load_model as jload_model

from dca_tpu_torch.models import core
from dca_tpu_torch.models.network import AE_types, load_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

h5py = pytest.importorskip("h5py")

G, HID = 40, (12, 6, 12)
OUT_KEYS = ("output", "mean", "disp", "pi", "latent")


def _batch(B=9, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.normal(size=(B, G)).astype(np.float32),
            rs.uniform(0.5, 2.0, size=B).astype(np.float32))


def _forward(net):
    x, sf = _batch()
    with torch.no_grad():
        out, _ = core.apply(net.definition, net.model, torch.from_numpy(x),
                            torch.from_numpy(sf))
    return {k: None if out[k] is None else out[k].numpy() for k in OUT_KEYS}


def _jforward(jnet):
    x, sf = _batch()
    out, _ = jcore.apply(jnet.definition, jnet.params, jnet.state, x, sf, training=False)
    return {k: None if out[k] is None else np.asarray(out[k]) for k in OUT_KEYS}


def _assert_outputs(got, want, exact=False):
    for k in OUT_KEYS:
        assert (got[k] is None) == (want[k] is None), k
        if got[k] is None:
            continue
        if exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def _net(ae_type, seed=0, **kw):
    name, _, variant = ae_type.partition("/")
    if variant == "sharedpi":
        kw["sharedpi"] = True
    return AE_types[name](input_size=G, hidden_size=HID, seed=seed, device="cpu", **kw).build()


def _jnet(ae_type, seed=0, **kw):
    name, _, variant = ae_type.partition("/")
    if variant == "sharedpi":
        kw["sharedpi"] = True
    return JAE[name](input_size=G, hidden_size=HID, seed=seed, **kw).build()


# ---------------------------------------------------------------------------
# the flat weights.hdf5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ae_type", ["zinb-conddisp", "nb-fork", "zinb"])
def test_weights_hdf5_crosses_both_ways(tmp_path, ae_type):
    """The port's file has the JAX package's keys; each package loads the
    other's, and the forwards agree within 1e-5."""
    net = _net(ae_type, seed=3)
    jnet = _jnet(ae_type, seed=5)
    port_file, jax_file = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    net.save_weights(port_file)
    jnet.save_weights(jax_file)
    with h5py.File(port_file) as a, h5py.File(jax_file) as b:
        keys = []
        a.visit(lambda k: keys.append(k) if isinstance(a[k], h5py.Dataset) else None)
        jkeys = []
        b.visit(lambda k: jkeys.append(k) if isinstance(b[k], h5py.Dataset) else None)
        assert sorted(keys) == sorted(jkeys)
        assert "params/heads/mean/kernel" in keys

    jloaded = _jnet(ae_type, seed=9)
    jloaded.load_weights(port_file)
    _assert_outputs(_jforward(jloaded), _forward(net))
    loaded = _net(ae_type, seed=9)
    loaded.load_weights(jax_file)
    _assert_outputs(_forward(loaded), _jforward(jnet))
    again = _net(ae_type, seed=9)
    again.load_weights(port_file)
    _assert_outputs(_forward(again), _forward(net), exact=True)


def test_load_weights_copies_in_place(tmp_path):
    """A load keeps every tensor's storage: the parameters and BN buffers
    are written through, not rebound."""
    src, dst = _net("zinb-conddisp", seed=1), _net("zinb-conddisp", seed=2)
    path = str(tmp_path / "w.hdf5")
    src.save_weights(path)
    before = {k: v.data_ptr() for k, v in dst.model.state_dict().items()}
    dst.load_weights(path)
    for k, v in dst.model.state_dict().items():
        assert v.data_ptr() == before[k], k
        assert torch.equal(v, src.model.state_dict()[k]), k


def test_predict_after_load_matches_jax(tmp_path):
    """predict(return_info=True) of a port network loaded from the JAX
    package's weights.hdf5, against the JAX network's, within 1e-5."""
    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData

    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData

    from conftest import make_counts

    counts = make_counts(50, G, seed=8)
    jnet = _jnet("zinb-conddisp", seed=4)
    path = str(tmp_path / "w.hdf5")
    jnet.save_weights(path)
    net = _net("zinb-conddisp", seed=0)
    net.load_weights(path)
    jad = jio.normalize(jio.read_dataset(JAnnData(counts.copy())))
    ad = io.normalize(io.read_dataset(AnnData(counts.copy())))
    jres = jnet.predict(jad, mode="full", return_info=True, copy=True)
    res = net.predict(ad, mode="full", return_info=True, copy=True)
    np.testing.assert_allclose(res.X, jres.X, rtol=1e-5, atol=1e-5)
    for key in ("X_dca", "X_dca_dispersion", "X_dca_dropout"):
        np.testing.assert_allclose(res.obsm[key], jres.obsm[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# the reference's Keras weights.hdf5 (the fixture of tests/test_keras_interop.py)
# ---------------------------------------------------------------------------


def _keras_weight_file(path, net, seed=0):
    """Write net-compatible random weights as a Keras-2 weights.hdf5;
    returns them keyed as the trees are."""
    rs = np.random.RandomState(seed)
    defn = net.definition
    layer_entries = [("count", {})]  # (keras layer name, {weight name: array})
    assigned = {"trunk": {}, "branches": {}, "heads": {}}
    bn_counter = [0]

    def _dense_entries(layers, sink):
        for ld in layers:
            k = rs.normal(scale=0.1, size=(ld.in_dim, ld.units)).astype(np.float32)
            b = rs.normal(scale=0.1, size=(ld.units,)).astype(np.float32)
            sink[ld.name] = {"kernel": k, "bias": b}
            layer_entries.append((ld.name, {f"{ld.name}/kernel:0": k, f"{ld.name}/bias:0": b}))
            if ld.batchnorm:
                bn_counter[0] += 1
                bname = f"batch_normalization_{bn_counter[0]}"
                beta = rs.normal(scale=0.1, size=(ld.units,)).astype(np.float32)
                mm = rs.normal(scale=0.1, size=(ld.units,)).astype(np.float32)
                mv = rs.uniform(0.5, 2.0, size=(ld.units,)).astype(np.float32)
                sink[ld.name].update(bn_beta=beta, moving_mean=mm, moving_var=mv)
                layer_entries.append((bname, {f"{bname}/beta:0": beta,
                                              f"{bname}/moving_mean:0": mm,
                                              f"{bname}/moving_variance:0": mv}))
            layer_entries.append((f"{ld.name}_act", {}))

    _dense_entries(list(defn.shared), assigned["trunk"])
    for bname_, layers in defn.branches.items():
        assigned["branches"][bname_] = {}
        _dense_entries(layers, assigned["branches"][bname_])
    for hname, head in defn.heads.items():
        if head.kind == "constant":
            th = rs.normal(scale=0.1, size=(1, head.units)).astype(np.float32)
            assigned["heads"][hname] = {"theta": th}
            layer_entries.append((head.name, {f"{head.name}/theta:0": th}))
            continue
        shape = (head.units,) if head.kind == "elementwise" else (head.in_dim, head.units)
        k = rs.normal(scale=0.1, size=shape).astype(np.float32)
        b = rs.normal(scale=0.1, size=(head.units,)).astype(np.float32)
        assigned["heads"][hname] = {"kernel": k, "bias": b}
        layer_entries.append((head.name, {f"{head.name}/kernel:0": k,
                                          f"{head.name}/bias:0": b}))
    layer_entries += [("size_factors", {}), ("slice", {})]

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n, _ in layer_entries])
        for lname, weights in layer_entries:
            g = f.create_group(lname)
            g.attrs["weight_names"] = np.array([w.encode() for w in weights])
            for wname, arr in weights.items():
                g.create_dataset(wname, data=arr)
    return assigned


def _install(net, assigned):
    """Set the generated weights directly on a control network."""
    sd = {}
    for group in ("trunk", "heads"):
        for lname, w in assigned[group].items():
            for leaf, arr in w.items():
                sd[f"{group}.{lname}.{leaf}"] = torch.from_numpy(arr)
    for b, layers in assigned["branches"].items():
        for lname, w in layers.items():
            for leaf, arr in w.items():
                sd[f"branches.{b}.{lname}.{leaf}"] = torch.from_numpy(arr)
    net.model.load_state_dict(sd, strict=True)


ARCHS = sorted(AE_types) + ["zinb-elempi/sharedpi"]


@pytest.mark.parametrize("ae_type", ARCHS)
def test_keras_weights_hdf5_loads(tmp_path, ae_type):
    """A reference Keras weights.hdf5 gives the forward of a network that
    carries its weights, the same bits in the port, and the JAX package's
    loaded forward within 1e-5."""
    path = str(tmp_path / "weights.hdf5")
    assigned = _keras_weight_file(path, _net(ae_type), seed=3)
    control = _net(ae_type)
    _install(control, assigned)
    loaded = _net(ae_type, seed=1)
    loaded.load_weights(path)
    _assert_outputs(_forward(loaded), _forward(control), exact=True)
    jloaded = _jnet(ae_type, seed=1)
    jloaded.load_weights(path)
    _assert_outputs(_forward(loaded), _jforward(jloaded))


def test_keras_weights_wrong_arch_raises(tmp_path):
    """The JAX package's messages: a layer without a counterpart names the
    layer, a missing layer is listed."""
    path = str(tmp_path / "weights.hdf5")
    _keras_weight_file(path, _net("zinb-conddisp"))
    dst = _net("nb-conddisp")
    with pytest.raises(ValueError, match="Keras layer 'pi' has weights but no counterpart "
                                         "in this 'nb-conddisp' network"):
        dst.load_weights(path)
    path = str(tmp_path / "nb.hdf5")
    _keras_weight_file(path, _net("nb-conddisp"))
    with pytest.raises(ValueError, match=r"weights file is missing layers \['pi'\] for "
                                         "ae_type 'zinb-conddisp'"):
        _net("zinb-conddisp").load_weights(path)


# ---------------------------------------------------------------------------
# model.pickle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_model_pickle_loads_across(tmp_path, writer):
    """Each package's trained-state model.pickle rebuilds the network in the
    other, with its weights: the forwards agree within 1e-5."""
    if writer == "jax":
        src = _jnet("zinb-fork", seed=6, file_path=str(tmp_path))
        src.save()
        net = load_model(str(tmp_path / "model.pickle"), device="cpu")
        want = _jforward(src)
        got = _forward(net)
    else:
        src = _net("zinb-fork", seed=6, file_path=str(tmp_path))
        src.save()
        net = jload_model(str(tmp_path / "model.pickle"))
        want = _forward(src)
        got = _jforward(net)
    assert net.ae_type == "zinb-fork" and net.hidden_size == HID
    _assert_outputs(got, want)


def test_own_model_pickle_loads_the_same_bits(tmp_path):
    src = _net("nb", seed=6, file_path=str(tmp_path), batchnorm=False)
    src.save()
    net = load_model(str(tmp_path / "model.pickle"), device="cpu")
    assert net.ae_type == "nb" and net.input_size == G and not net.batchnorm
    _assert_outputs(_forward(net), _forward(src), exact=True)


def test_reference_model_pickle_loads(tmp_path):
    """A model.pickle holding the reference's pre-build Keras object (whose
    classes are not importable here) rebuilds the right network."""
    mod = types.ModuleType("dca.network")

    class ZINBAutoencoder:  # stand-in for the reference class
        pass

    ZINBAutoencoder.__module__ = "dca.network"
    ZINBAutoencoder.__qualname__ = "ZINBAutoencoder"
    mod.ZINBAutoencoder = ZINBAutoencoder
    pkg = types.ModuleType("dca")
    pkg.network = mod
    sys.modules["dca"] = pkg
    sys.modules["dca.network"] = mod
    try:
        obj = ZINBAutoencoder()
        obj.__dict__.update(
            input_size=55, output_size=55, hidden_size=(16, 8, 16),
            l2_coef=0.0, l1_coef=0.0, l2_enc_coef=0.0, l1_enc_coef=0.0,
            ridge=0.2, hidden_dropout=0.0, input_dropout=0.0,
            batchnorm=True, activation="relu", init="glorot_uniform",
            file_path=None, debug=False,
            # reference-only attributes, ignored
            loss=None, extra_models={}, model=None, encoder=None,
            decoder=None, input_layer=None, sf_layer=None,
        )
        path = str(tmp_path / "model.pickle")
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    finally:
        del sys.modules["dca"], sys.modules["dca.network"]

    net = load_model(path, device="cpu")
    assert net.ae_type == "zinb-conddisp"
    assert net.input_size == 55 and net.hidden_size == (16, 8, 16) and net.ridge == 0.2
    assert net.model is not None  # built, ready for load_weights


def test_load_model_defaults_to_the_card(tmp_path, monkeypatch):
    """Without device="cpu" load_model builds on the CUDA device, and raises
    where there is none (no silent fallback to the CPU)."""
    src = _net("nb-conddisp", file_path=str(tmp_path))
    src.save()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(str(tmp_path / "model.pickle"))
