"""Reference-element basis functions and quadrature tables (numpy copy of
``ocean_jax/fem/reference.py``).

The P1/P2 Lagrange bases on the reference triangle and the Gauss rules
are small closed-form tables evaluated once at setup; assembly is batched
einsums over these tables.

Conventions:
  * reference triangle: vertices (0,0), (1,0), (0,1); barycentrics
    λ = (1-ξ-η, ξ, η),
  * P2 dofs 0..2 at vertices, dof 3+i at the midpoint of the edge opposite
    vertex i (edge i connects vertices (i+1)%3, (i+2)%3),
  * quadrature weights include the reference-triangle area factor, i.e.
    ∫_T f ≈ detJ · Σ_q w_q f(x_q) with Σ w_q = 1/2.

Quadrature degrees are chosen so that every polynomial integrand appearing
in the reference's forms is integrated exactly (the NS convection term
(∇u·u)·v has degree 5 on cells; boundary terms reach degree 6 on edges),
which makes the assembly agree with dolfin's auto-degree FFC quadrature
to rounding error.
"""

from __future__ import annotations

import numpy as np


def p1_basis(xi: np.ndarray) -> np.ndarray:
    """P1 basis at reference points. xi: (..., 2) → (..., 3)."""
    x, y = xi[..., 0], xi[..., 1]
    return np.stack([1.0 - x - y, x, y], axis=-1)


P1_GRAD = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, 2), constant


def p2_basis(xi: np.ndarray) -> np.ndarray:
    """P2 basis at reference points. xi: (..., 2) → (..., 6)."""
    lam = p1_basis(xi)
    l0, l1, l2 = lam[..., 0], lam[..., 1], lam[..., 2]
    return np.stack(
        [
            l0 * (2 * l0 - 1),
            l1 * (2 * l1 - 1),
            l2 * (2 * l2 - 1),
            4 * l1 * l2,   # midpoint of edge opposite vertex 0
            4 * l0 * l2,   # opposite vertex 1
            4 * l0 * l1,   # opposite vertex 2
        ],
        axis=-1,
    )


def p2_grad_ref(xi: np.ndarray) -> np.ndarray:
    """Reference gradients of the P2 basis. xi: (..., 2) → (..., 6, 2)."""
    lam = p1_basis(xi)
    grads = []
    for a in range(3):
        grads.append((4 * lam[..., a] - 1)[..., None] * P1_GRAD[a])
    pairs = [(1, 2), (0, 2), (0, 1)]
    for (i, j) in pairs:
        grads.append(4 * (lam[..., i][..., None] * P1_GRAD[j]
                          + lam[..., j][..., None] * P1_GRAD[i]))
    return np.stack(grads, axis=-2)


def triangle_quadrature(degree: int = 6):
    """Symmetric Gauss rules on the reference triangle (weights sum to 1/2).

    degree 2: 3-point; degree 4: 6-point; degree 6: 12-point (Dunavant).
    """
    if degree <= 2:
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        wts = np.full(3, 1 / 6)
        return pts, wts
    if degree <= 4:
        a1, b1, w1 = 0.816847572980459, 0.091576213509771, 0.109951743655322
        a2, b2, w2 = 0.108103018168070, 0.445948490915965, 0.223381589678011
        bary = []
        wts = []
        for (a, b, w) in ((a1, b1, w1), (a2, b2, w2)):
            bary += [(a, b, b), (b, a, b), (b, b, a)]
            wts += [w, w, w]
        bary = np.array(bary)
        return bary[:, 1:], 0.5 * np.array(wts)
    # Dunavant degree-6, 12 points
    g1a, g1b, w1 = 0.873821971016996, 0.063089014491502, 0.050844906370207
    g2a, g2b, w2 = 0.501426509658179, 0.249286745170910, 0.116786275726379
    g3a, g3b, g3c, w3 = (0.636502499121399, 0.310352451033785,
                         0.053145049844816, 0.082851075618374)
    bary = []
    wts = []
    for (a, b, w) in ((g1a, g1b, w1), (g2a, g2b, w2)):
        bary += [(a, b, b), (b, a, b), (b, b, a)]
        wts += [w, w, w]
    for perm in ((g3a, g3b, g3c), (g3a, g3c, g3b), (g3b, g3a, g3c),
                 (g3c, g3a, g3b), (g3b, g3c, g3a), (g3c, g3b, g3a)):
        bary.append(perm)
        wts.append(w3)
    bary = np.array(bary)
    wts = np.array(wts)
    # barycentric (λ0, λ1, λ2) → reference (ξ, η) = (λ1, λ2)
    return bary[:, 1:], 0.5 * wts


def gauss_legendre_01(n: int = 4):
    """n-point Gauss–Legendre rule on [0, 1] (exact to degree 2n-1)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w
