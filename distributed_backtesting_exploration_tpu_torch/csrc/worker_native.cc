// Native worker shell of the PyTorch port: a C++ binary that owns the
// process, checks the native runtime core, and runs the port's worker CLI
// through an embedded CPython interpreter (the reference's
// cpp/worker_native.cc, which shells into the JAX engine the same way).
// The control loop, channels and compute bridge live in
// distributed_backtesting_exploration_tpu_torch.rpc.worker; argv goes to
// its main() unchanged.
//
// Build: runtime/_core.py build_worker_shell() (one g++ command, into the
// package's _build/). Run from anywhere:
//   _build/dbx_worker_native --connect localhost:50051 --backend torch
//
// Compile-time definitions:
//   DBX_PYTHON_EXE  the interpreter that ran the build; the embedded one
//                   takes its sys.executable and so the same prefix and
//                   site-packages (a virtual environment's included);
//   DBX_HAVE_PROTO  the JobSpec round trip through the C++ code generated
//                   from the port's rpc/backtesting.proto.

#include <Python.h>

#include <unistd.h>

#include <climits>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "dbx_core.h"

#ifdef DBX_HAVE_PROTO
#include "backtesting.pb.h"
#endif

namespace {

const char kCsv[] =
    "open,high,low,close,volume\n"
    "1.0,2.0,0.5,1.5,100\n"
    "1.5,2.5,1.0,2.0,200\n";

#ifdef DBX_HAVE_PROTO
// The wire contract, natively: a JobSpec carrying a DBX1 payload made by
// the native codec is serialized, parsed back, and every field compared.
bool proto_selftest() {
  DbxOhlcv o;
  char err[128];
  if (dbx_csv_decode(kCsv, sizeof(kCsv) - 1, &o, err, sizeof(err)) != 0) {
    return false;
  }
  uint8_t* wire = nullptr;
  const size_t n = dbx_ohlcv_to_wire(&o, &wire);
  dbx_ohlcv_free(&o);
  if (n == 0) return false;

  dbx::rpc::JobSpec spec;
  spec.set_id("native-proto-selftest");
  spec.set_strategy("sma_crossover");
  spec.set_ohlcv(wire, n);
  spec.set_cost(0.001f);
  spec.set_periods_per_year(252);
  spec.set_wf_train(504);
  spec.set_wf_test(63);
  spec.set_wf_metric("sharpe");
  spec.set_top_k(16);
  spec.set_rank_metric("sortino");
  auto& fast = (*spec.mutable_grid())["fast"];
  fast.add_values(5.0f);
  fast.add_values(10.0f);
  std::string blob;
  const bool ser = spec.SerializeToString(&blob);

  dbx::rpc::JobSpec back;
  bool ok = ser && back.ParseFromString(blob) &&
            back.id() == "native-proto-selftest" &&
            back.strategy() == "sma_crossover" &&
            back.ohlcv().size() == n &&
            std::memcmp(back.ohlcv().data(), wire, n) == 0 &&
            back.grid().at("fast").values_size() == 2 &&
            back.grid().at("fast").values(1) == 10.0f &&
            back.periods_per_year() == 252 &&
            back.wf_train() == 504 && back.wf_test() == 63 &&
            back.wf_metric() == "sharpe" &&
            back.top_k() == 16 && back.rank_metric() == "sortino";
  dbx_bytes_free(wire);

  // The payload decodes back through the native wire decoder.
  DbxOhlcv o2{};
  ok = ok &&
       dbx_wire_decode(
           reinterpret_cast<const uint8_t*>(back.ohlcv().data()),
           back.ohlcv().size(), &o2, err, sizeof(err)) == 0 &&
       o2.n_bars == 2 && o2.close[1] == 2.0f;
  dbx_ohlcv_free(&o2);
  return ok;
}
#endif

// The native queue across threads, then CSV -> wire -> decode: a broken
// core fails here, before the interpreter starts.
bool core_selftest() {
  DbxQueue* q = dbx_queue_new(4);
  const char payload[] = "job-bytes";
  std::thread producer([q, &payload] {
    for (int i = 0; i < 8; ++i) {
      dbx_queue_push(q, reinterpret_cast<const uint8_t*>(payload),
                     sizeof(payload), -1);
    }
    dbx_queue_close(q);
  });
  int popped = 0;
  bool same = true;
  for (;;) {
    uint8_t* data = nullptr;
    size_t len = 0;
    if (dbx_queue_pop(q, &data, &len, 1000) != 0) break;
    same = same && len == sizeof(payload) &&
           std::memcmp(data, payload, len) == 0;
    dbx_bytes_free(data);
    ++popped;
  }
  producer.join();
  dbx_queue_free(q);
  if (!same || popped != 8) return false;

  DbxOhlcv o;
  char err[128];
  if (dbx_csv_decode(kCsv, sizeof(kCsv) - 1, &o, err, sizeof(err)) != 0) {
    std::fprintf(stderr, "csv selftest: %s\n", err);
    return false;
  }
  uint8_t* wire = nullptr;
  const size_t n = dbx_ohlcv_to_wire(&o, &wire);
  DbxOhlcv o2{};
  const bool ok = n > 0 && dbx_wire_decode(wire, n, &o2, err, sizeof(err)) == 0
                  && o2.n_bars == 2 && o2.close[1] == 2.0f;
  dbx_bytes_free(wire);
  dbx_ohlcv_free(&o);
  dbx_ohlcv_free(&o2);
  return ok;
}

// The repository root: three levels above this binary
// (<root>/distributed_backtesting_exploration_tpu_torch/_build/<binary>).
std::string repo_root() {
  char buf[PATH_MAX];
  const ssize_t n = readlink("/proc/self/exe", buf, sizeof(buf) - 1);
  if (n <= 0) return "";
  std::string path(buf, static_cast<size_t>(n));
  for (int i = 0; i < 3; ++i) {
    const size_t cut = path.rfind('/');
    if (cut == std::string::npos || cut == 0) return "";
    path.resize(cut);
  }
  return path;
}

// A Python string literal of ``s`` (repr-safe for any path).
std::string py_literal(const std::string& s) {
  std::string out = "'";
  for (const char c : s) {
    if (c == '\\' || c == '\'') out.push_back('\\');
    out.push_back(c);
  }
  out.push_back('\'');
  return out;
}

}  // namespace

int main(int argc, char** argv) {
  if (!core_selftest()) {
    std::fprintf(stderr, "dbx_worker_native: core selftest FAILED\n");
    return 2;
  }
  std::fprintf(stderr, "dbx_worker_native: core selftest ok\n");
#ifdef DBX_HAVE_PROTO
  if (!proto_selftest()) {
    std::fprintf(stderr, "dbx_worker_native: proto selftest FAILED\n");
    return 2;
  }
  std::fprintf(stderr, "dbx_worker_native: proto selftest ok\n");
#else
  std::fprintf(stderr, "dbx_worker_native: proto selftest skipped "
                       "(built without libprotobuf)\n");
#endif

  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  // argv is the worker CLI's, not the interpreter's: without parse_argv=0
  // Python would take flags like --help itself.
  config.parse_argv = 0;
  PyStatus status = PyConfig_SetBytesArgv(&config, argc, argv);
#ifdef DBX_PYTHON_EXE
  if (!PyStatus_Exception(status) && access(DBX_PYTHON_EXE, X_OK) == 0) {
    status = PyConfig_SetBytesString(&config, &config.executable,
                                     DBX_PYTHON_EXE);
  }
#endif
  if (PyStatus_Exception(status)) {
    PyConfig_Clear(&config);
    std::fprintf(stderr, "dbx_worker_native: interpreter config failed\n");
    return 2;
  }
  status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    std::fprintf(stderr, "dbx_worker_native: interpreter init failed\n");
    return 2;
  }

  const std::string root = repo_root();
  std::string boot = "import sys\n";
  if (!root.empty()) {
    boot += "sys.path.insert(0, " + py_literal(root) + ")\n";
  }
  boot +=
      "from distributed_backtesting_exploration_tpu_torch.rpc import worker\n"
      "worker.main(sys.argv[1:])\n";
  const int rc = PyRun_SimpleString(boot.c_str());
  if (Py_FinalizeEx() < 0) return 120;
  return rc == 0 ? 0 : 1;
}
