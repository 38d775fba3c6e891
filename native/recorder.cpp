// Native row-stream recorder/extractor data plane.
//
// JAX-native re-implementation of the reference's core/recorders runtime
// (ref: core/recorders/data_record.hpp:159 data_recorder, :334 data_extractor,
// data_record.cpp threaded row buffering, bin_recorder.hpp:47,
// ssv_recorder.hpp, tcp_recorder.hpp, udp_recorder.hpp,
// network_recorder.cpp:28,128-129 Boost.Asio streaming) — written fresh in
// portable C++17 + POSIX sockets, no Boost.
//
// Wire/file format (shared with reak_tpu.io.recorder Python back-ends):
//   header: one JSON line {"columns": ["a", "b", ...]}\n
//   rows:   packed little-endian float64, n_columns per row
//
// C ABI (consumed via ctypes from reak_tpu/io/native_recorder.py):
//   rk_rec_open(uri, columns_csv)  -> handle (>0) or 0 on error
//   rk_rec_write(handle, const double*, n)   (enqueues; background flush)
//   rk_rec_flush(handle)           (drain queue + fsync-level flush)
//   rk_rec_close(handle)
//   rk_ext_open(uri) / rk_ext_ncols / rk_ext_colname / rk_ext_read /
//   rk_ext_close
//   rk_rec_last_error()            -> static string
//
// URIs: "file.bin", "file.csv", "tcp://host:port", "udp://host:port".
// Build: g++ -O2 -std=c++17 -shared -fPIC recorder.cpp -o libreak_recorder.so -lpthread

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

static thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

// ---------------------------------------------------------------- sinks ----

struct Sink {
  virtual ~Sink() = default;
  virtual bool write(const char* data, size_t n) = 0;
  virtual void flush() {}
};

struct FileSink : Sink {
  FILE* f = nullptr;
  explicit FileSink(const std::string& path) { f = std::fopen(path.c_str(), "wb"); }
  ~FileSink() override { if (f) std::fclose(f); }
  bool ok() const { return f != nullptr; }
  bool write(const char* data, size_t n) override {
    return f && std::fwrite(data, 1, n, f) == n;
  }
  void flush() override { if (f) std::fflush(f); }
};

struct SocketSink : Sink {
  int fd = -1;
  bool dgram = false;
  sockaddr_in addr{};

  // (ref: tcp_recorder.hpp / udp_recorder.hpp connection setup)
  SocketSink(const std::string& host, int port, bool udp) : dgram(udp) {
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = udp ? SOCK_DGRAM : SOCK_STREAM;
    if (getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints, &res) != 0 ||
        !res) {
      set_error("getaddrinfo failed for " + host);
      return;
    }
    std::memcpy(&addr, res->ai_addr, sizeof(addr));
    freeaddrinfo(res);
    fd = ::socket(AF_INET, udp ? SOCK_DGRAM : SOCK_STREAM, 0);
    if (fd < 0) { set_error("socket() failed"); return; }
    if (!udp && ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
      set_error("connect() failed");
      ::close(fd);
      fd = -1;
    }
  }
  ~SocketSink() override { if (fd >= 0) ::close(fd); }
  bool ok() const { return fd >= 0; }
  bool write(const char* data, size_t n) override {
    if (fd < 0) return false;
    if (dgram) {
      return ::sendto(fd, data, n, 0, reinterpret_cast<sockaddr*>(&addr),
                      sizeof(addr)) == static_cast<ssize_t>(n);
    }
    size_t off = 0;
    while (off < n) {
      ssize_t w = ::send(fd, data + off, n - off, 0);
      if (w <= 0) return false;
      off += static_cast<size_t>(w);
    }
    return true;
  }
};

// ----------------------------------------------------------- recorder ----

// Background-flushed row recorder (ref: data_record.cpp worker-thread
// buffering; rows accumulate in a deque drained by one flusher thread).
struct Recorder {
  std::vector<std::string> columns;
  std::unique_ptr<Sink> sink;
  bool csv = false;

  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<double>> queue;
  std::atomic<bool> closing{false};
  bool busy = false;  // worker is mid-emit (guards flush() vs in-flight row)
  std::atomic<bool> failed{false};
  std::thread worker;

  void start() {
    write_header();
    worker = std::thread([this] { run(); });
  }

  void write_header() {
    std::ostringstream os;
    if (csv) {
      for (size_t i = 0; i < columns.size(); ++i)
        os << (i ? "," : "") << columns[i];
      os << "\n";
    } else {
      os << "{\"columns\": [";
      for (size_t i = 0; i < columns.size(); ++i)
        os << (i ? ", " : "") << '"' << columns[i] << '"';
      os << "]}\n";
    }
    const std::string h = os.str();
    if (!sink->write(h.data(), h.size())) failed = true;
  }

  void emit(const std::vector<double>& row) {
    if (csv) {
      std::ostringstream os;
      char buf[32];
      for (size_t i = 0; i < row.size(); ++i) {
        std::snprintf(buf, sizeof(buf), "%.17g", row[i]);
        os << (i ? "," : "") << buf;
      }
      os << "\n";
      const std::string s = os.str();
      if (!sink->write(s.data(), s.size())) failed = true;
    } else {
      if (!sink->write(reinterpret_cast<const char*>(row.data()),
                       row.size() * sizeof(double)))
        failed = true;
    }
  }

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv.wait(lk, [this] { return closing || !queue.empty(); });
      while (!queue.empty()) {
        std::vector<double> row = std::move(queue.front());
        queue.pop_front();
        busy = true;
        lk.unlock();
        emit(row);
        lk.lock();
        busy = false;
      }
      if (closing) break;
      cv.notify_all();  // wake any flush() waiter
    }
    sink->flush();
    cv.notify_all();
  }

  void push(const double* data, size_t n) {
    std::vector<double> row(data, data + n);
    {
      std::lock_guard<std::mutex> lk(mu);
      queue.push_back(std::move(row));
    }
    cv.notify_all();
  }

  void flush() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return queue.empty() && !busy; });
    sink->flush();
  }

  void close() {
    {
      std::lock_guard<std::mutex> lk(mu);
      closing = true;
    }
    cv.notify_all();
    if (worker.joinable()) worker.join();
  }
};

// ----------------------------------------------------------- extractor ----

// (ref: data_extractor, data_record.hpp:334; binary/CSV file readers)
struct Extractor {
  std::vector<std::string> columns;
  FILE* f = nullptr;
  bool csv = false;

  ~Extractor() { if (f) std::fclose(f); }

  bool open(const std::string& path) {
    csv = path.size() > 4 && path.substr(path.size() - 4) == ".csv";
    f = std::fopen(path.c_str(), "rb");
    if (!f) { set_error("cannot open " + path); return false; }
    std::string line;
    int c;
    while ((c = std::fgetc(f)) != EOF && c != '\n') line.push_back(char(c));
    if (csv) {
      std::stringstream ss(line);
      std::string tok;
      while (std::getline(ss, tok, ',')) columns.push_back(tok);
    } else {
      // parse {"columns": ["a", "b"]} without a JSON lib
      size_t pos = 0;
      while ((pos = line.find('"', pos)) != std::string::npos) {
        size_t end = line.find('"', pos + 1);
        if (end == std::string::npos) break;
        std::string tok = line.substr(pos + 1, end - pos - 1);
        if (tok != "columns") columns.push_back(tok);
        pos = end + 1;
      }
    }
    return !columns.empty();
  }

  // returns 1 on row read, 0 on EOF
  int read(double* out) {
    if (!f) return 0;
    if (csv) {
      std::string line;
      int c;
      while ((c = std::fgetc(f)) != EOF && c != '\n') line.push_back(char(c));
      if (line.empty() && c == EOF) return 0;
      std::stringstream ss(line);
      std::string tok;
      size_t i = 0;
      while (std::getline(ss, tok, ',') && i < columns.size())
        out[i++] = std::strtod(tok.c_str(), nullptr);
      return i == columns.size() ? 1 : 0;
    }
    size_t n = std::fread(out, sizeof(double), columns.size(), f);
    return n == columns.size() ? 1 : 0;
  }
};

// ------------------------------------------------------------- registry ----

std::mutex g_reg_mu;
std::map<int64_t, std::unique_ptr<Recorder>> g_recs;
std::map<int64_t, std::unique_ptr<Extractor>> g_exts;
int64_t g_next = 1;

bool parse_net(const std::string& uri, const char* scheme, std::string* host,
               int* port) {
  const std::string pre = std::string(scheme) + "://";
  if (uri.rfind(pre, 0) != 0) return false;
  const std::string rest = uri.substr(pre.size());
  const size_t colon = rest.rfind(':');
  if (colon == std::string::npos) return false;
  *host = rest.substr(0, colon);
  *port = std::atoi(rest.c_str() + colon + 1);
  return true;
}

}  // namespace

extern "C" {

const char* rk_rec_last_error() { return g_last_error.c_str(); }

int64_t rk_rec_open(const char* uri_c, const char* columns_csv) {
  std::string uri(uri_c);
  auto rec = std::make_unique<Recorder>();
  {
    std::stringstream ss(columns_csv);
    std::string tok;
    while (std::getline(ss, tok, ',')) rec->columns.push_back(tok);
  }
  if (rec->columns.empty()) { set_error("no columns"); return 0; }

  std::string host;
  int port = 0;
  if (parse_net(uri, "tcp", &host, &port)) {
    auto s = std::make_unique<SocketSink>(host, port, /*udp=*/false);
    if (!s->ok()) return 0;
    rec->sink = std::move(s);
  } else if (parse_net(uri, "udp", &host, &port)) {
    auto s = std::make_unique<SocketSink>(host, port, /*udp=*/true);
    if (!s->ok()) return 0;
    rec->sink = std::move(s);
  } else {
    rec->csv = uri.size() > 4 && uri.substr(uri.size() - 4) == ".csv";
    auto s = std::make_unique<FileSink>(uri);
    if (!s->ok()) { set_error("cannot open " + uri); return 0; }
    rec->sink = std::move(s);
  }
  rec->start();
  std::lock_guard<std::mutex> lk(g_reg_mu);
  const int64_t h = g_next++;
  g_recs[h] = std::move(rec);
  return h;
}

int rk_rec_write(int64_t h, const double* row, int64_t n) {
  Recorder* r = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_reg_mu);
    auto it = g_recs.find(h);
    if (it == g_recs.end()) { set_error("bad handle"); return -1; }
    r = it->second.get();
  }
  if (static_cast<size_t>(n) != r->columns.size()) {
    set_error("row width mismatch (ref: data_record out_of_bounds)");
    return -1;
  }
  if (r->failed) { set_error("sink failed"); return -1; }
  r->push(row, static_cast<size_t>(n));
  return 0;
}

int rk_rec_write_batch(int64_t h, const double* rows, int64_t k, int64_t n) {
  Recorder* r = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_reg_mu);
    auto it = g_recs.find(h);
    if (it == g_recs.end()) { set_error("bad handle"); return -1; }
    r = it->second.get();
  }
  if (static_cast<size_t>(n) != r->columns.size()) {
    set_error("row width mismatch (ref: data_record out_of_bounds)");
    return -1;
  }
  if (r->failed) { set_error("sink failed"); return -1; }
  {
    std::lock_guard<std::mutex> lk(r->mu);
    for (int64_t i = 0; i < k; ++i)
      r->queue.emplace_back(rows + i * n, rows + (i + 1) * n);
  }
  r->cv.notify_all();
  return 0;
}

int rk_rec_flush(int64_t h) {
  std::lock_guard<std::mutex> lk(g_reg_mu);
  auto it = g_recs.find(h);
  if (it == g_recs.end()) return -1;
  it->second->flush();
  return it->second->failed ? -1 : 0;
}

int rk_rec_close(int64_t h) {
  std::unique_ptr<Recorder> r;
  {
    std::lock_guard<std::mutex> lk(g_reg_mu);
    auto it = g_recs.find(h);
    if (it == g_recs.end()) return -1;
    r = std::move(it->second);
    g_recs.erase(it);
  }
  r->close();
  return r->failed ? -1 : 0;
}

int64_t rk_ext_open(const char* uri_c) {
  auto ext = std::make_unique<Extractor>();
  if (!ext->open(uri_c)) return 0;
  std::lock_guard<std::mutex> lk(g_reg_mu);
  const int64_t h = g_next++;
  g_exts[h] = std::move(ext);
  return h;
}

int64_t rk_ext_ncols(int64_t h) {
  std::lock_guard<std::mutex> lk(g_reg_mu);
  auto it = g_exts.find(h);
  return it == g_exts.end() ? -1 : static_cast<int64_t>(it->second->columns.size());
}

const char* rk_ext_colname(int64_t h, int64_t i) {
  std::lock_guard<std::mutex> lk(g_reg_mu);
  auto it = g_exts.find(h);
  if (it == g_exts.end() || i < 0 ||
      static_cast<size_t>(i) >= it->second->columns.size())
    return "";
  return it->second->columns[static_cast<size_t>(i)].c_str();
}

int rk_ext_read(int64_t h, double* out) {
  Extractor* e = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_reg_mu);
    auto it = g_exts.find(h);
    if (it == g_exts.end()) return -1;
    e = it->second.get();
  }
  return e->read(out);
}

int rk_ext_close(int64_t h) {
  std::lock_guard<std::mutex> lk(g_reg_mu);
  return g_exts.erase(h) ? 0 : -1;
}

}  // extern "C"
