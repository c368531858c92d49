"""Greedy graph coloring of (agglomerated) elements.

Rebuild of the reference's GetElementColoring (Coloring.hpp:19-90): BFS
ordering from a seed element, then first-fit coloring so that adjacent
elements (sharing a facet) never share a color. Used by the visualization
layer to paint agglomerates distinguishably
(Visualization.cpp:55, :259 — element and coarse-facet colorings).
"""

import numpy as np
import scipy.sparse as sp


def get_element_coloring(el_el, el0: int = 0) -> np.ndarray:
    """First-fit coloring in BFS order over the adjacency matrix el_el
    (any scipy sparse, diagonal entries allowed and ignored). Returns an
    int array of colors, adjacent entities guaranteed distinct."""
    G = sp.csr_matrix(el_el)
    n = G.shape[0]
    colors = np.full(n, -2, dtype=np.int64)
    order = []
    # BFS from el0, restarting at the next unvisited element (the reference
    # walks el = (el+1) % n)
    max_deg = int(np.diff(G.indptr).max()) if n else 0
    for seed in list(range(el0, n)) + list(range(0, el0)):
        if colors[seed] != -2:
            continue
        colors[seed] = -1
        p = len(order)
        order.append(seed)
        while p < len(order):
            i = order[p]
            p += 1
            for k in G.indices[G.indptr[i]:G.indptr[i + 1]]:
                if colors[k] == -2:
                    colors[k] = -1
                    order.append(int(k))
    marker = np.zeros(max_deg + 2, dtype=bool)
    for i in order:
        nbrs = G.indices[G.indptr[i]:G.indptr[i + 1]]
        used = colors[nbrs]
        marker[:] = False
        marker[used[used >= 0]] = True
        colors[i] = int(np.argmin(marker))
    return colors
