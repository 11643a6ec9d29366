"""The port's copies of the jax-free vector modules give the JAX package's
results: the dataset and the numpy graph/oracle paths (``device="cpu"``)
exactly, the torch paths (what a CUDA device runs at 10^6 rows, run here on
CPU tensors) up to distance ties."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.vector import dataset as jdata  # noqa: E402
from repro.vector import graph as jgraph  # noqa: E402
from repro.vector import ref as jref  # noqa: E402
from repro_torch.vector import dataset as tdata  # noqa: E402
from repro_torch.vector import graph as tgraph  # noqa: E402
from repro_torch.vector import ref as tref  # noqa: E402


@pytest.fixture(scope="module")
def data():
    return jdata.make_dataset(1500, 32, num_clusters=8, num_queries=40,
                              seed=5)


@pytest.mark.parametrize("n,d,seed", [(1500, 32, 5), (300, 64, 0)])
def test_dataset_identical(n, d, seed):
    for a, b in zip(jdata.make_dataset(n, d, seed=seed, num_queries=17),
                    tdata.make_dataset(n, d, seed=seed, num_queries=17)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("degree,long_edges", [(8, 2), (16, 2), (8, 0)])
def test_numpy_graph_identical(data, degree, long_edges):
    db, _ = data
    np.testing.assert_array_equal(
        tgraph.make_cagra_graph(db, degree, seed=3, long_edges=long_edges,
                                device="cpu"),
        jgraph.make_cagra_graph(db, degree, seed=3, long_edges=long_edges))


def test_torch_knn_rows_match_numpy(data):
    """The torch kNN path (the card's graph builder) finds the numpy
    path's neighbours; only ties between equal distances may reorder."""
    db, _ = data
    rows = np.arange(db.shape[0])
    want = jgraph._exact_knn_rows(db, rows, 16)
    got = tgraph._exact_knn_rows_torch(db, rows, 16, 512, torch.device("cpu"))
    assert (got == want).mean() > 0.999
    assert all(len(set(a) & set(b)) >= 15 for a, b in zip(got, want))
    g = tgraph.make_cagra_graph(db, 8, exact_threshold=db.shape[0],
                                device="cpu")
    assert g.shape == (db.shape[0], 8) and g.dtype == np.int32
    assert (g >= 0).all() and (g < db.shape[0]).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_knn_numpy_and_torch(data, metric):
    db, queries = data
    want_ids, want_d = jref.exact_knn(db, queries, 10, metric=metric)
    ids, d = tref.exact_knn(db, queries, 10, metric=metric, device="cpu")
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(d, want_d)
    tids, td = tref._exact_knn_torch(db, queries, 10, metric, 16,
                                     torch.device("cpu"))
    assert tref.recall_at_k(tids, want_ids) > 0.999
    np.testing.assert_allclose(td, want_d, rtol=1e-4, atol=1e-3)
    assert tref.recall_at_k(ids, want_ids) == jref.recall_at_k(ids, want_ids)
