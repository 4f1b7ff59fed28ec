"""Model FLOPs of one epoch: the work the reference model needs, whatever
implements it.

* A Linear is dense over the real nodes' rows at its published widths:
  2·rows·in·out forward; its backward is two such products (the input's
  gradient and the weight's), one where the input needs no gradient.
* An aggregation costs (directed edges) × width, twice where it is
  weighted; its backward costs the same again.  The cut loss is an
  aggregation of the one-hot classes.
* Forward and backward both count; padding, recomputation, elementwise
  work and the optimizer do not.
"""

from __future__ import annotations

from typing import Sequence


def linear(rows: int, n_in: int, n_out: int, input_grad: bool) -> float:
    """A Linear forward and backward."""
    one = 2.0 * rows * n_in * n_out
    return one * (3 if input_grad else 2)


def aggregation(directed_edges: int, width: int, weighted: bool = False) -> float:
    """An aggregation forward and backward."""
    return 2.0 * directed_edges * width * (2 if weighted else 1)


def gcn_layer(rows: int, directed_edges: int, n_in: int, n_out: int, input_grad: bool) -> float:
    """GraphConv (norm='both'): the Linear, and the aggregation at the
    narrower side (DGL projects first when out < in)."""
    return linear(rows, n_in, n_out, input_grad) + aggregation(directed_edges, min(n_in, n_out))


def recipe_graph(n: int, directed_edges: int, n_in: int, hidden: int, classes: int) -> float:
    """One graph's step of the recipe: GCNSoftmax n_in → hidden → classes on
    adjacency features (no input gradient), then the STE cut loss."""
    return (gcn_layer(n, directed_edges, n_in, hidden, input_grad=False)
            + gcn_layer(n, directed_edges, hidden, classes, input_grad=True)
            + aggregation(directed_edges, classes))


def recipe_epoch(graphs: Sequence[tuple], n_in: int, hidden: int, classes: int) -> float:
    """An epoch over ``graphs``, each (n, directed edges)."""
    return sum(recipe_graph(n, e, n_in, hidden, classes) for n, e in graphs)


def giant_epoch(n: int, d: int, embedding: int, hidden: int, classes: int) -> float:
    """An epoch of the giant trainer: a learned embedding (its gradient
    counts), GraphConv embedding → hidden → classes on a d-regular graph,
    then the cut loss."""
    e = n * d
    return (gcn_layer(n, e, embedding, hidden, input_grad=True)
            + gcn_layer(n, e, hidden, classes, input_grad=True)
            + aggregation(e, classes))
