// fedml_host — native host-side message transport for fedml_tpu.
//
// The reference's native transport work all lives in external libraries
// (mpi4py→libmpi, grpcio→gRPC C-core, torch.distributed.rpc→TensorPipe;
// SURVEY.md §2.0 — no in-tree native code).  This library is the
// TPU-framework equivalent: a length-prefixed TCP message fabric for the
// control plane (cross-silo/edge participants outside the device mesh),
// bound into Python with ctypes (comm/native_tcp.py).  The dense data
// plane stays on XLA collectives — this carries Messages, not tensors.
//
// Wire format (identical to the pure-Python TcpBackend, the behavioral
// spec): 8-byte little-endian payload length ‖ payload bytes.
//
// C ABI (ctypes-friendly, no exceptions cross the boundary):
//   fh_server_create(port)            -> handle (listen + accept loop)
//   fh_recv(h, &buf, &len, timeout)   -> 0 ok / -1 timeout / -2 closed
//   fh_buf_free(buf)
//   fh_connect(host, port)            -> conn handle (nullptr on failure)
//   fh_send(conn, buf, len)           -> 0 ok / -1 error
//   fh_conn_close(conn), fh_server_close(h)

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

bool read_exact(int fd, uint8_t* dst, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t r = ::recv(fd, dst + off, n - off, 0);
    if (r <= 0) return false;
    off += static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const uint8_t* src, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t w = ::send(fd, src + off, n - off, MSG_NOSIGNAL);
    if (w <= 0) return false;
    off += static_cast<size_t>(w);
  }
  return true;
}

struct Server {
  int listen_fd = -1;
  std::atomic<bool> alive{true};
  std::thread accept_thread;
  std::vector<std::thread> recv_threads;
  std::vector<int> conn_fds;       // for shutdown-on-close (unblocks recv)
  std::mutex conn_mu;              // guards recv_threads/conn_fds growth
  std::mutex mu;                   // guards inbox
  std::condition_variable cv;
  std::deque<std::vector<uint8_t>> inbox;

  void recv_loop(int fd) {
    for (;;) {
      uint8_t hdr[8];
      if (!alive.load() || !read_exact(fd, hdr, 8)) break;
      uint64_t len = 0;
      std::memcpy(&len, hdr, 8);   // little-endian hosts only (x86/arm)
      if (len > (1ull << 30)) break;   // 1 GiB cap (matches the reference's
                                       // gRPC max-message, §2.1) — a corrupt
                                       // header must not OOM the process
      std::vector<uint8_t> payload;
      try {
        payload.resize(len);
      } catch (const std::bad_alloc&) {
        break;                         // drop the connection, keep serving
      }
      if (!read_exact(fd, payload.data(), len)) break;
      {
        std::lock_guard<std::mutex> g(mu);
        inbox.emplace_back(std::move(payload));
      }
      cv.notify_one();
    }
    {
      // deregister before close so a later fh_server_close cannot
      // shutdown() a kernel-reused fd belonging to another socket
      std::lock_guard<std::mutex> g(conn_mu);
      for (auto it = conn_fds.begin(); it != conn_fds.end(); ++it) {
        if (*it == fd) { conn_fds.erase(it); break; }
      }
    }
    ::close(fd);
  }

  void accept_loop() {
    while (alive.load()) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (!alive.load()) return;
        continue;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> g(conn_mu);
      conn_fds.push_back(fd);
      recv_threads.emplace_back([this, fd] { recv_loop(fd); });
    }
  }
};

struct Conn {
  int fd = -1;
  std::mutex mu;                   // serialize frames on one connection
};

}  // namespace

extern "C" {

void* fh_server_create(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 128) != 0) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Server();
  s->listen_fd = fd;
  s->accept_thread = std::thread([s] { s->accept_loop(); });
  return s;
}

// 0 = ok (buf/len set, caller frees via fh_buf_free); -1 = timeout; -2 closed
int fh_recv(void* handle, uint8_t** out, long* out_len, int timeout_ms) {
  auto* s = static_cast<Server*>(handle);
  std::unique_lock<std::mutex> lk(s->mu);
  auto ready = [&] { return !s->inbox.empty() || !s->alive.load(); };
  if (timeout_ms < 0) {
    s->cv.wait(lk, ready);
  } else if (!s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                             ready)) {
    return -1;
  }
  if (s->inbox.empty()) return -2;   // woken by shutdown
  std::vector<uint8_t> msg = std::move(s->inbox.front());
  s->inbox.pop_front();
  lk.unlock();
  auto* buf = static_cast<uint8_t*>(::malloc(msg.size()));
  std::memcpy(buf, msg.data(), msg.size());
  *out = buf;
  *out_len = static_cast<long>(msg.size());
  return 0;
}

void fh_buf_free(uint8_t* buf) { ::free(buf); }

// non-blocking connect with timeout (the pure-Python spec used
// create_connection(timeout=30); kernel-default connect can block minutes)
void* fh_connect_timeout(const char* host, int port, int timeout_ms) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  std::snprintf(portstr, sizeof(portstr), "%d", port);
  if (::getaddrinfo(host, portstr, &hints, &res) != 0 || res == nullptr)
    return nullptr;
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0) {
    ::freeaddrinfo(res);
    return nullptr;
  }
  int flags = ::fcntl(fd, F_GETFL, 0);
  ::fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  int rc = ::connect(fd, res->ai_addr, res->ai_addrlen);
  ::freeaddrinfo(res);
  if (rc != 0) {
    if (errno != EINPROGRESS) {
      ::close(fd);
      return nullptr;
    }
    pollfd pfd{fd, POLLOUT, 0};
    if (::poll(&pfd, 1, timeout_ms) != 1) {
      ::close(fd);
      return nullptr;
    }
    int err = 0;
    socklen_t len = sizeof(err);
    if (::getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len) != 0 || err != 0) {
      ::close(fd);
      return nullptr;
    }
  }
  ::fcntl(fd, F_SETFL, flags);   // back to blocking for send()
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Conn();
  c->fd = fd;
  return c;
}

void* fh_connect(const char* host, int port) {
  return fh_connect_timeout(host, port, 30000);
}

int fh_send(void* conn, const uint8_t* data, long len) {
  auto* c = static_cast<Conn*>(conn);
  uint64_t n = static_cast<uint64_t>(len);
  uint8_t hdr[8];
  std::memcpy(hdr, &n, 8);
  std::lock_guard<std::mutex> g(c->mu);
  if (!write_exact(c->fd, hdr, 8)) return -1;
  if (!write_exact(c->fd, data, n)) return -1;
  return 0;
}

void fh_conn_close(void* conn) {
  auto* c = static_cast<Conn*>(conn);
  ::shutdown(c->fd, SHUT_RDWR);
  ::close(c->fd);
  delete c;
}

void fh_server_close(void* handle) {
  auto* s = static_cast<Server*>(handle);
  s->alive.store(false);
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  s->cv.notify_all();
  if (s->accept_thread.joinable()) s->accept_thread.join();
  std::vector<std::thread> threads;
  {
    // shutdown live fds under the lock, but join OUTSIDE it — exiting
    // recv_loops take conn_mu to deregister their fd
    std::lock_guard<std::mutex> g(s->conn_mu);
    for (int fd : s->conn_fds) ::shutdown(fd, SHUT_RDWR);  // unblock recv()
    threads.swap(s->recv_threads);
  }
  for (auto& t : threads)
    if (t.joinable()) t.join();
  delete s;
}

}  // extern "C"
