"""BVH: host-side median-split build + wavefront stack traversal on device.

This replaces the hardware acceleration structures the
reference gets from Vulkan (VK_KHR_acceleration_structure,
rene/src/main.rs:2417-2908). The BVH is *data*, not a driver object:

* Build (numpy, at scene compile): top-down splits at the centroid median of
  the widest axis, leaf size <= LEAF_SIZE; triangles are reordered so each
  leaf owns a contiguous range. Iterative (explicit stack), vectorized
  partition per node.
* Traversal (jnp, inside jit): one `lax.while_loop` over the whole ray
  wavefront; every lane carries a short stack (depth-bounded), the current
  node, and its running closest hit. Internal nodes test both child slabs
  against the running t and descend the near child, pushing the far child;
  leaves run a fixed LEAF_SIZE-wide Möller–Trumbore. All lanes advance in
  lock-step with masking, like warp-synchronous traversal.

Node SoA layout (M = number of nodes):
  aabb_min/aabb_max (M,3), left (M,) i32 (internal: left child; leaf: prim
  range start), right (M,) i32 (internal: right child; leaf: prim count),
  is_leaf (M,) bool. Node 0 is the root. `order` (T,) maps reordered prim
  slots to original triangle ids.
"""
from __future__ import annotations

import numpy as np

LEAF_SIZE = 4
MAX_DEPTH_STACK = 40  # SAH depth over <=1M tris is ~2*log2(N/4)


class BVH:
    def __init__(self, aabb_min, aabb_max, left, right, is_leaf, order,
                 tri_p_sorted):
        self.aabb_min = aabb_min
        self.aabb_max = aabb_max
        self.left = left
        self.right = right
        self.is_leaf = is_leaf
        self.order = order
        self.tri_p_sorted = tri_p_sorted
        self._device = None

    @property
    def num_nodes(self):
        return self.left.shape[0]

    def to_device(self):
        import jax.numpy as jnp
        self._device = {
            "aabb_min": jnp.asarray(self.aabb_min),
            "aabb_max": jnp.asarray(self.aabb_max),
            "left": jnp.asarray(self.left),
            "right": jnp.asarray(self.right),
            "is_leaf": jnp.asarray(self.is_leaf),
            "order": jnp.asarray(self.order),
            "tri_p": jnp.asarray(self.tri_p_sorted),
        }
        return self

    # -- traversal ----------------------------------------------------------
    def intersect(self, org, direction, tmin, tmax):
        """Closest-hit over the tree. Returns (t, original_prim_id)."""
        import jax
        import jax.numpy as jnp

        from .intersect import BIG_T, moller_trumbore

        d = self._device if self._device is not None else None
        if d is None:
            self.to_device()
            d = self._device

        n = org.shape[0]
        inv_d = 1.0 / jnp.where(jnp.abs(direction) > 1e-20, direction,
                                jnp.where(direction >= 0, 1e-20, -1e-20))

        def slab(node_idx, t_best):
            bmin = d["aabb_min"][node_idx]
            bmax = d["aabb_max"][node_idx]
            t0 = (bmin - org) * inv_d
            t1 = (bmax - org) * inv_d
            tn = jnp.minimum(t0, t1)
            tf = jnp.maximum(t0, t1)
            t_near = jnp.maximum(jnp.max(tn, axis=-1), tmin)
            t_far = jnp.minimum(jnp.min(tf, axis=-1),
                                jnp.minimum(t_best, tmax))
            return t_near, (t_near <= t_far)

        carry = {
            "stack": jnp.zeros((n, MAX_DEPTH_STACK), jnp.int32),
            "sp": jnp.zeros((n,), jnp.int32),  # stack size
            "node": jnp.zeros((n,), jnp.int32),
            "live": jnp.ones((n,), bool),      # lane still traversing
            "t": jnp.minimum(jnp.full((n,), BIG_T), tmax + 0.0 * tmax),
            "prim": jnp.full((n,), -1, jnp.int32),
        }
        # root cull
        root_near, root_hit = slab(jnp.zeros((n,), jnp.int32), carry["t"])
        carry["live"] = root_hit

        def cond(c):
            return jnp.any(c["live"])

        def body(c):
            node = c["node"]
            live = c["live"]
            leaf = d["is_leaf"][node] & live
            internal = ~d["is_leaf"][node] & live

            # ---- internal: test children
            lchild = d["left"][node]
            rchild = d["right"][node]
            lt, lhit = slab(lchild, c["t"])
            rt, rhit = slab(rchild, c["t"])
            lhit = lhit & internal
            rhit = rhit & internal
            both = lhit & rhit
            near_is_l = lt <= rt
            near = jnp.where(near_is_l, lchild, rchild)
            far = jnp.where(near_is_l, rchild, lchild)
            one = lhit ^ rhit
            next_node = jnp.where(both, near,
                                  jnp.where(lhit, lchild, rchild))
            push = both
            sp = c["sp"]
            stack = c["stack"]
            stack = jnp.where(
                (push & (sp < MAX_DEPTH_STACK))[:, None]
                & (jnp.arange(MAX_DEPTH_STACK)[None, :] == sp[:, None]),
                far[:, None], stack)
            sp = jnp.where(push, jnp.minimum(sp + 1, MAX_DEPTH_STACK), sp)
            descend = both | one

            # ---- leaf: fixed-width triangle tests
            start = d["left"][node]
            count = d["right"][node]
            t_best = c["t"]
            prim_best = c["prim"]
            for k in range(LEAF_SIZE):
                slot = jnp.clip(start + k, 0, d["tri_p"].shape[0] - 1)
                p = d["tri_p"][slot]
                tk, _, _, hitk = moller_trumbore(
                    org, direction, p[:, None, 0], p[:, None, 1],
                    p[:, None, 2], tmin, jnp.minimum(t_best, tmax))
                hitk = hitk[:, 0] & leaf & (k < count)
                tk = tk[:, 0]
                closer = hitk & (tk < t_best)
                t_best = jnp.where(closer, tk, t_best)
                prim_best = jnp.where(closer, d["order"][slot], prim_best)

            # ---- advance: leaves and dead-ended internals pop
            need_pop = leaf | (internal & ~descend)
            can_pop = sp > 0
            sp_idx = jnp.maximum(sp - 1, 0)
            popped = jnp.take_along_axis(stack, sp_idx[:, None],
                                         axis=1)[:, 0]
            new_node = jnp.where(need_pop, popped, next_node)
            new_sp = jnp.where(need_pop & can_pop, sp - 1, sp)
            new_live = live & ~(need_pop & ~can_pop)

            return {
                "stack": stack,
                "sp": new_sp,
                "node": jnp.where(live, new_node, node),
                "live": new_live,
                "t": t_best,
                "prim": prim_best,
            }

        out = jax.lax.while_loop(cond, body, carry)
        t = out["t"]
        miss = out["prim"] < 0
        return (jnp.where(miss, BIG_T, t),
                jnp.where(miss, 0, out["prim"]).astype(jnp.int32))


def _tree_depth(left, right, is_leaf) -> int:
    """Max root-to-leaf depth (root = depth 0), iterative BFS."""
    depth = 0
    frontier = [0] if left.shape[0] else []
    d = 0
    while frontier:
        depth = d
        nxt = []
        for node in frontier:
            if not is_leaf[node]:
                nxt.append(int(left[node]))
                nxt.append(int(right[node]))
        frontier = nxt
        d += 1
    return depth


def build_bvh(tri_p: np.ndarray, use_native: bool = True) -> BVH:
    """BVH build over (T,3,3) world-space triangles.

    Prefers the native C++ binned-SAH builder (native/bvh_builder.cpp via
    ctypes); falls back to the numpy median-split builder below. A native
    tree deeper than the traversal stack (possible for pathological SAH
    splits) would silently drop far children in `intersect`, so such trees
    are rebuilt with median splits (depth <= ceil(log2(N/LEAF_SIZE)) + 1,
    always well under MAX_DEPTH_STACK).
    """
    tri_p = np.asarray(tri_p, np.float32)
    if use_native and tri_p.shape[0] > 0:
        from .native import native_build_bvh
        out = native_build_bvh(tri_p, LEAF_SIZE)
        if out is not None:
            aabb_min, aabb_max, left, right, is_leaf, order = out
            # reserve one slot: traversal pushes at most depth-1 far children
            if _tree_depth(left, right, is_leaf) < MAX_DEPTH_STACK:
                return _finish(tri_p, aabb_min, aabb_max, left, right,
                               is_leaf, order.astype(np.int64))
            import logging
            logging.getLogger("rene_tpu.bvh").warning(
                "native SAH tree exceeds the %d-entry traversal stack; "
                "rebuilding with median splits", MAX_DEPTH_STACK)
    return _build_median(tri_p)


def _finish(tri_p, aabb_min, aabb_max, left, right, is_leaf, order):
    ntri = tri_p.shape[0]
    pad = (-ntri) % LEAF_SIZE  # allow fixed-width leaf loop to over-read
    order32 = order.astype(np.int32)
    tri_sorted = tri_p[order]
    if pad:
        tri_sorted = np.concatenate(
            [tri_sorted, np.zeros((pad, 3, 3), np.float32)], axis=0)
        order32 = np.concatenate([order32, np.zeros(pad, np.int32)], axis=0)
    return BVH(aabb_min, aabb_max, left.astype(np.int32),
               right.astype(np.int32), np.asarray(is_leaf, bool), order32,
               tri_sorted)


def _build_median(tri_p: np.ndarray) -> BVH:
    """Numpy median-split fallback builder."""
    ntri = tri_p.shape[0]
    lo = tri_p.min(axis=1)  # (T,3)
    hi = tri_p.max(axis=1)
    centroid = 0.5 * (lo + hi)

    order = np.arange(ntri, dtype=np.int64)

    max_nodes = max(2 * ntri - 1, 1)
    aabb_min = np.zeros((max_nodes, 3), np.float32)
    aabb_max = np.zeros((max_nodes, 3), np.float32)
    left = np.zeros(max_nodes, np.int32)
    right = np.zeros(max_nodes, np.int32)
    is_leaf = np.zeros(max_nodes, bool)
    n_nodes = 1

    # iterative build: (node_id, start, end)
    stack = [(0, 0, ntri)]
    while stack:
        node, s, e = stack.pop()
        ids = order[s:e]
        aabb_min[node] = lo[ids].min(axis=0)
        aabb_max[node] = hi[ids].max(axis=0)
        count = e - s
        if count <= LEAF_SIZE:
            is_leaf[node] = True
            left[node] = s
            right[node] = count
            continue
        c = centroid[ids]
        ext = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            mid = count // 2  # degenerate: split in half by current order
        else:
            mid = count // 2
            part = np.argpartition(c[:, axis], mid)
            order[s:e] = ids[part]
        lnode, rnode = n_nodes, n_nodes + 1
        n_nodes += 2
        left[node] = lnode
        right[node] = rnode
        stack.append((lnode, s, s + mid))
        stack.append((rnode, s + mid, e))

    return _finish(tri_p, aabb_min[:n_nodes], aabb_max[:n_nodes],
                   left[:n_nodes], right[:n_nodes], is_leaf[:n_nodes], order)
