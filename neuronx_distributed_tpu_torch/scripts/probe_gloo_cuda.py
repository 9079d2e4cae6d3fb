"""Which ``torch.distributed`` ops gloo runs on CUDA tensors, with four
ranks sharing ``cuda:0`` (the way ``chip_smoke.py`` runs its ranks):

    python3 -m neuronx_distributed_tpu_torch.scripts.probe_gloo_cuda

Each rank runs every op in turn and logs it; an op that aborts the
process (gloo's send/recv on a CUDA pointer do) is recorded and skipped in
the next world. Prints one line per op: OK, FAIL with the error, or CRASH.
Its finding that send/recv crash is why :func:`..parallel.comm.ppermute`
stages through host memory. The int8 and uint8 cases are the
expert-parallel wire's codes (:mod:`..parallel.ep_dispatch`: int8 as
such, fp8 as its bytes), on a two-rank group as an ep group is."""
import os, subprocess, sys, tempfile, time
import torch

OPS = ["all_reduce_sum", "all_reduce_max", "all_reduce_bf16",
       "all_reduce_int64", "broadcast", "all_gather_list",
       "all_gather_into_tensor", "reduce_scatter_list",
       "reduce_scatter_tensor", "all_to_all_single", "all_to_all_list",
       "send_recv", "batch_isend_irecv", "subgroup_all_reduce",
       "all_gather_into_tensor_int8", "all_to_all_single_int8",
       "subgroup_all_to_all_single_uint8"]


def child(rank, world, store, skip, log):
    import torch.distributed as dist
    out = open(log, "w", buffering=1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sub = dist.new_group([0, 1])
    x = torch.full((4, 6), float(rank + 1), device=dev)
    nxt, prv = (rank + 1) % world, (rank - 1) % world

    def run(name):
        if name == "all_reduce_sum":
            y = x.clone(); dist.all_reduce(y); assert y[0, 0].item() == sum(range(1, world + 1))
        elif name == "all_reduce_max":
            y = x.clone(); dist.all_reduce(y, op=dist.ReduceOp.MAX); assert y[0, 0].item() == world
        elif name == "all_reduce_bf16":
            y = x.to(torch.bfloat16); dist.all_reduce(y); assert y[0, 0].item() == sum(range(1, world + 1))
        elif name == "all_reduce_int64":
            y = torch.ones(3, device=dev, dtype=torch.int64); dist.all_reduce(y); assert y[0].item() == world
        elif name == "broadcast":
            y = x.clone(); dist.broadcast(y, src=0); assert y[0, 0].item() == 1
        elif name == "all_gather_list":
            outs = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(outs, x); assert outs[-1][0, 0].item() == world
        elif name == "all_gather_into_tensor":
            o = torch.empty((4 * world, 6), device=dev)
            dist.all_gather_into_tensor(o, x); assert o[-1, 0].item() == world
        elif name == "reduce_scatter_list":
            o = torch.empty((2, 6), device=dev)
            dist.reduce_scatter(o, [torch.ones((2, 6), device=dev) for _ in range(world)])
            assert o[0, 0].item() == world
        elif name == "reduce_scatter_tensor":
            o = torch.empty((1, 6), device=dev)
            dist.reduce_scatter_tensor(o, torch.ones((world, 6), device=dev)); assert o[0, 0].item() == world
        elif name == "all_to_all_single":
            inp = torch.arange(world * 3, device=dev, dtype=torch.float32) + 100 * rank
            o = torch.empty_like(inp)
            dist.all_to_all_single(o, inp); assert o[3 * (world - 1)].item() == 100 * (world - 1) + 3 * rank
        elif name == "all_to_all_list":
            inp = [torch.full((2,), float(rank * 10 + j), device=dev) for j in range(world)]
            o = [torch.empty(2, device=dev) for _ in range(world)]
            dist.all_to_all(o, inp); assert o[1][0].item() == 10 + rank
        elif name == "send_recv":
            y = torch.empty_like(x)
            if rank % 2 == 0:
                dist.send(x, nxt); dist.recv(y, prv)
            else:
                dist.recv(y, prv); dist.send(x, nxt)
            assert y[0, 0].item() == prv + 1
        elif name == "batch_isend_irecv":
            y = torch.empty_like(x)
            for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt), dist.P2POp(dist.irecv, y, prv)]):
                w.wait()
            assert y[0, 0].item() == prv + 1
        elif name == "subgroup_all_reduce":
            if rank < 2:
                y = x.clone(); dist.all_reduce(y, group=sub); assert y[0, 0].item() == 3
        elif name == "all_gather_into_tensor_int8":
            q = torch.full((4, 6), rank - 2, device=dev, dtype=torch.int8)
            o = torch.empty((4 * world, 6), device=dev, dtype=torch.int8)
            dist.all_gather_into_tensor(o, q); assert o[-1, 0].item() == world - 3
        elif name == "all_to_all_single_int8":
            inp = (torch.arange(world * 3, device=dev) + 10 * rank).to(torch.int8)
            o = torch.empty_like(inp)
            dist.all_to_all_single(o, inp); assert o[3 * (world - 1)].item() == 10 * (world - 1) + 3 * rank
        elif name == "subgroup_all_to_all_single_uint8":
            if rank < 2:
                inp = (torch.arange(4, device=dev) + 100 * rank).to(torch.uint8)
                o = torch.empty_like(inp)
                dist.all_to_all_single(o, inp, group=sub); assert o[2].item() == 100 + 2 * rank
        torch.cuda.synchronize()

    for name in OPS:
        if name in skip:
            continue
        out.write(f"START {name}\n")
        try:
            run(name)
            out.write(f"OK {name}\n")
        except Exception as e:
            out.write(f"FAIL {name} {repr(e)[:160]}\n")
        dist.barrier()
    out.write("DONE\n")
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["child"]:
        child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
              set(filter(None, sys.argv[5].split(","))), sys.argv[6])
        sys.exit(0)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    world, skip, verdict = 4, [], {}
    for rnd in range(len(OPS)):
        d = tempfile.mkdtemp()
        logs = [os.path.join(d, f"r{r}.log") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, __file__, "child", str(r), str(world), os.path.join(d, "store"), ",".join(skip), logs[r]],
                                  stdout=subprocess.DEVNULL, stderr=subprocess.PIPE) for r in range(world)]
        t0 = time.time()
        while time.time() - t0 < 90 and any(p.poll() is None for p in procs):
            time.sleep(0.5)
        for p in procs:
            if p.poll() is None:
                p.kill()
        lines = open(logs[0]).read().split("\n") if os.path.exists(logs[0]) else []
        started = None
        for ln in lines:
            if ln.startswith("START "):
                started = ln.split()[1]
            elif ln.startswith(("OK ", "FAIL ")):
                verdict[ln.split()[1]] = ln
                started = None
        if "DONE" in lines:
            break
        if started is None:
            print("no progress; stderr:", procs[0].stderr.read()[-600:], flush=True)
            break
        err = procs[0].stderr.read().decode(errors="replace").strip().splitlines()
        verdict[started] = f"CRASH {started} " + (err[-1][:160] if err else "")
        skip.append(started)
        print("round", rnd, "crashed on", started, f"{time.time()-t0:.1f}s", flush=True)
    for name in OPS:
        print(f"{name:26s} {verdict.get(name, 'not run')}")
