"""Ways to compute a convex hull's support value max_v d.v on the card, at
mini_cheetah/flat's mesh-mesh size (B=4096 envs, 40 pairs, 8 directions per
pair, 672 vertices per hull), each timed with a host clock around 5 calls:

  a   one batched product (B, G, 8, 3) @ (B, G, 3, V), then the max;
  a2  the same product transposed, the max over the other axis;
  b   one product per distinct hull (the pairs of 3 hulls), all the
      directions of its pairs as rows against its own vertices (the form
      `physics/collision.py::HullSet` ships);
  c   three broadcast multiply-adds over (B, G, 8, V);
  d   a gather of 56 candidate vertices per direction from a (hull, bin)
      table, then the product and the max (d2: the product as a matmul).

It prints the bound of writing and reading the (B, G, 8, V) products once
at 3.35 TB/s beside them. Random data: the numbers time the arithmetic,
not the narrow phase.

    python3 scripts/torch_port/hull_support_bench.py
"""

import time

import torch

B, G, N, V = 4096, 40, 8, 672
KC, BINS = 56, 1536


def timeit(f, n=5):
    f()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        f()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device='cuda').manual_seed(0)
    W = torch.randn(B, G, V, 3, device='cuda', generator=g)
    d = torch.randn(B, G, N, 3, device='cuda', generator=g)
    hulls = torch.randn(3, V, 3, device='cuda', generator=g)
    mesh = torch.arange(G, device='cuda') % 3
    pairs = [(mesh == k).nonzero()[:, 0] for k in range(3)]
    table = torch.randn(3, BINS, KC, 3, device='cuda', generator=g)
    bins = torch.randint(0, BINS, (B, G, N), device='cuda', generator=g)

    def per_hull():
        out = d.new_empty(B, G, N)
        for k, sel in enumerate(pairs):
            u = d[:, sel].reshape(-1, 3)
            out[:, sel] = (u @ hulls[k].T).amax(-1).reshape(B, len(sel), N)
        return out

    def gathered(matmul):
        c = table[mesh[None, :, None], bins]                  # (B, G, N, KC, 3)
        if matmul:
            return (c @ d[..., :, None])[..., 0].amax(-1)
        return (c * d[..., None, :]).sum(-1).amax(-1)

    print(f'bytes bound ms {B * G * N * V * 4 * 2 / 3.35e12 * 1e3:.4f}')
    print(f'a batched matmul+amax {timeit(lambda: (d @ W.transpose(-1, -2)).amax(-1)):.4f}')
    print(f'a2 batched (V,3)@(3,N) amax(-2) '
          f'{timeit(lambda: (W @ d.transpose(-1, -2)).amax(-2)):.4f}')
    print(f'b big GEMM per mesh {timeit(per_hull):.4f}')
    print(f'c elementwise {timeit(lambda: (d[..., :, None, 0] * W[..., None, :, 0] + d[..., :, None, 1] * W[..., None, :, 1] + d[..., :, None, 2] * W[..., None, :, 2]).amax(-1)):.4f}')  # noqa: E501
    print(f'd gather table Kc={KC} {timeit(lambda: gathered(False)):.4f}')
    print(f'd2 gather table matmul {timeit(lambda: gathered(True)):.4f}')


if __name__ == '__main__':
    main()
