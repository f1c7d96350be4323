"""epsilon_tpu: general convex programming on a GPU, in JAX.

A from-scratch re-design of Epsilon (mfouda/epsilon): a DCP frontend compiles
convex problems into prox-affine form ``minimize sum_i f_i(H_i(x)) s.t.
sum_i A_i x_i = b``; a JAX operator library evaluates the proximal operators
and structured linear maps; ADMM operator-splitting loops run entirely on
device under ``jit``, sharded consensus-style across a device mesh.

Public API mirrors ``python/epopt/__init__.py``::

    import epsilon_tpu as ep
    x = ep.Variable(n)
    prob = ep.Problem(ep.Minimize(ep.sum_squares(A @ x - b) + ep.norm1(x)))
    ep.solve(prob)   # or prob.solve()
"""

__version__ = "0.1.0"

from .frontend import *  # noqa: F401,F403
from .frontend import api, eval_prox, solve  # noqa: F401
from .frontend.api import Parameter, _wrap, scalar_constant  # noqa: F401
from .frontend.functions import (hinge_loss, infinite_push, logistic_loss,  # noqa: F401
                                 multiclass_hinge_loss, one_hot, poisson_loss,
                                 quantile_loss, softmax_loss)
from .ir import ProxKind  # noqa: F401
from .solvers import SolverKind, SolverParams, SolverStatus  # noqa: F401
