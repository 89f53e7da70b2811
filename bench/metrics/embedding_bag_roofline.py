"""The tower's embedding bag's share of its roofline in the profiled
slice: one nnz-1 bag a history position of each of the tower's rows (the
reference's selection at each batch), rows read only for ids that are not
padding (``work.bag_bytes``), over HBM's rate, divided by the launches'
device time."""
import torch


def read(ctx):
    s, bag = ctx.slice, ctx.fam.bag()
    if s is None or bag is None:
        return None
    t = s.kernel_seconds("embedding_bag")
    if t <= 0:
        return None
    dim, elem = bag
    B, need = ctx.traffic.batch, 0
    for i in ctx.slice_batches:
        rows = ctx.report.selected[i]
        uid = torch.as_tensor(ctx.stream.uid[i * B:(i + 1) * B],
                              device=rows.device)[rows]
        ids = ctx.feats.of(uid, torch.full_like(uid, ctx.stream.batch_now(i)))
        need += ctx.work.bag_bytes(ids.numel(), ids.numel(),
                                   int((ids >= 0).sum()), dim, elem)
    return 100.0 * need / ctx.work.PEAKS["hbm_bytes_per_s"] / t
