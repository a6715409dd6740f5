"""The AST check that a module of the port is a copy of its reference in
the JAX package: the two trees are compared once docstrings, the
``@hot_path`` markers and the package prefix are set aside."""

from __future__ import annotations

import ast
import inspect


class _Normalise(ast.NodeTransformer):
    """A module's tree without docstrings, ``@hot_path`` markers and the
    import of ``repro.analysis``, with the port's package name read as the
    reference's (module-level and function-level imports alike)."""

    def _strip_doc(self, node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    def visit_Module(self, node):
        return self._strip_doc(self.generic_visit(node))

    def visit_ClassDef(self, node):
        return self._strip_doc(self.generic_visit(node))

    def visit_ImportFrom(self, node):
        if node.module == "repro.analysis":
            return None
        if node.module.startswith("repro_torch."):
            node.module = "repro." + node.module[len("repro_torch."):]
        return node

    def visit_FunctionDef(self, node):
        node.decorator_list = [d for d in node.decorator_list
                               if not (isinstance(d, ast.Name)
                                       and d.id == "hot_path")]
        return self._strip_doc(self.generic_visit(node))


def normalised(module) -> str:
    """``ast.dump`` of ``module``'s normalised tree (see ``_Normalise``)."""
    tree = _Normalise().visit(ast.parse(inspect.getsource(module)))
    return ast.dump(tree)
