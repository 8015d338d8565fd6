// Native TCP message transport for the host-side distributed runtime.
//
// TPU-native counterpart of the reference's network layer
// (reference: src/graph/network/socket_communicator.cc Sender/Receiver,
// src/graph/network/tcp_socket.cc, src/graph/network/msg_queue.cc):
// a Sender maintains one connection per receiver; a Receiver accepts
// num_senders connections, one reader thread per connection, all pushing
// length-framed messages into a blocking queue.  Device-side collectives
// (gradient psum, halo all-to-all) ride XLA over ICI/DCN — this transport
// only carries host-side control/data-plane traffic: KVStore push/pull,
// sampler feeds, barriers (the role TCP plays in the reference).
//
// C ABI for ctypes: handles are opaque int64 ids.
#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Message {
  int sender_id;
  std::vector<char> data;
};

struct Queue {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Message> q;
  std::atomic<bool> closed{false};

  void push(Message&& m) {
    {
      std::lock_guard<std::mutex> lk(mu);
      q.push_back(std::move(m));
    }
    cv.notify_one();
  }
  // blocking pop; returns false when closed and drained
  bool pop(Message* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] { return !q.empty() || closed.load(); });
    if (q.empty()) return false;
    *out = std::move(q.front());
    q.pop_front();
    return true;
  }
};

static bool send_all(int fd, const char* buf, int64_t n) {
  while (n > 0) {
    ssize_t k = ::send(fd, buf, (size_t)n, MSG_NOSIGNAL);
    if (k <= 0) return false;
    buf += k;
    n -= k;
  }
  return true;
}

static bool recv_all(int fd, char* buf, int64_t n) {
  while (n > 0) {
    ssize_t k = ::recv(fd, buf, (size_t)n, 0);
    if (k <= 0) return false;
    buf += k;
    n -= k;
  }
  return true;
}

struct Receiver {
  int listen_fd = -1;
  Queue queue;
  std::mutex conn_mu;  // guards readers/conn_fds (acceptor appends)
  std::vector<std::thread> readers;
  std::vector<int> conn_fds;
  std::thread acceptor;
  std::atomic<int> connected{0};
  int num_senders = 0;

  ~Receiver() { stop(); }

  void stop() {
    queue.closed.store(true);
    queue.cv.notify_all();
    if (listen_fd >= 0) {
      ::shutdown(listen_fd, SHUT_RDWR);
      ::close(listen_fd);
      listen_fd = -1;
    }
    if (acceptor.joinable()) acceptor.join();
    {
      // unblock readers stuck in recv on live connections: the peer's
      // sender may outlive this receiver (teardown order is arbitrary)
      std::lock_guard<std::mutex> lk(conn_mu);
      for (int fd : conn_fds) ::shutdown(fd, SHUT_RDWR);
    }
    for (auto& t : readers)
      if (t.joinable()) t.join();
  }
};

struct Sender {
  std::vector<int> fds;
  std::mutex mu;  // sends are serialized per sender handle
  ~Sender() {
    for (int fd : fds)
      if (fd >= 0) ::close(fd);
  }
};

std::mutex g_mu;
std::map<int64_t, Receiver*> g_receivers;
std::map<int64_t, Sender*> g_senders;
int64_t g_next = 1;

void reader_loop(Receiver* r, int fd, int sender_id) {
  for (;;) {
    int64_t size = 0;
    if (!recv_all(fd, reinterpret_cast<char*>(&size), sizeof(size))) break;
    if (size < 0 || size > (int64_t(1) << 40)) break;
    Message m;
    m.sender_id = sender_id;
    m.data.resize((size_t)size);
    if (size > 0 && !recv_all(fd, m.data.data(), size)) break;
    if (r->queue.closed.load()) break;
    r->queue.push(std::move(m));
  }
  ::close(fd);
}

}  // namespace

extern "C" {

// Receiver: listen on port, expect num_senders connections (each sender
// first sends its int32 id).  Returns handle or -1.
int64_t nc_receiver_create(int port, int num_senders) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (::bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      ::listen(fd, num_senders + 8) != 0) {
    ::close(fd);
    return -1;
  }
  auto* r = new Receiver();
  r->listen_fd = fd;
  r->num_senders = num_senders;
  r->acceptor = std::thread([r] {
    while (r->connected.load() < r->num_senders && !r->queue.closed.load()) {
      int cfd = ::accept(r->listen_fd, nullptr, nullptr);
      if (cfd < 0) break;
      int one = 1;
      ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      int32_t sid = -1;
      if (!recv_all(cfd, reinterpret_cast<char*>(&sid), sizeof(sid))) {
        ::close(cfd);
        continue;
      }
      {
        std::lock_guard<std::mutex> lk(r->conn_mu);
        r->readers.emplace_back(reader_loop, r, cfd, (int)sid);
        r->conn_fds.push_back(cfd);
      }
      r->connected.fetch_add(1);
    }
  });
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next++;
  g_receivers[h] = r;
  return h;
}

int nc_receiver_wait_connected(int64_t h, int timeout_ms) {
  Receiver* r;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_receivers.find(h);
    if (it == g_receivers.end()) return -1;
    r = it->second;
  }
  for (int waited = 0; waited < timeout_ms; waited += 10) {
    if (r->connected.load() >= r->num_senders) return 0;
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  return r->connected.load() >= r->num_senders ? 0 : -1;
}

// Blocking receive.  Mallocs *buf (caller frees with nc_free).  Returns
// payload size, or -1 when the receiver is closed.
int64_t nc_recv(int64_t h, char** buf, int* sender_id) {
  Receiver* r;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_receivers.find(h);
    if (it == g_receivers.end()) return -1;
    r = it->second;
  }
  Message m;
  if (!r->queue.pop(&m)) return -1;
  *sender_id = m.sender_id;
  *buf = (char*)::malloc(m.data.size() ? m.data.size() : 1);
  std::memcpy(*buf, m.data.data(), m.data.size());
  return (int64_t)m.data.size();
}

void nc_free(char* buf) { ::free(buf); }

void nc_receiver_destroy(int64_t h) {
  Receiver* r = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_receivers.find(h);
    if (it == g_receivers.end()) return;
    r = it->second;
    g_receivers.erase(it);
  }
  delete r;
}

// Sender: connect to n receivers (ips "a.b.c.d", ports), announcing
// my_id on each connection.  Retries each connect for up to timeout_ms.
int64_t nc_sender_create(const char** ips, const int* ports, int n,
                         int my_id, int timeout_ms) {
  auto* s = new Sender();
  s->fds.assign(n, -1);
  for (int i = 0; i < n; ++i) {
    int fd = -1;
    for (int waited = 0;; waited += 50) {
      fd = ::socket(AF_INET, SOCK_STREAM, 0);
      sockaddr_in addr{};
      addr.sin_family = AF_INET;
      addr.sin_port = htons((uint16_t)ports[i]);
      ::inet_pton(AF_INET, ips[i], &addr.sin_addr);
      if (::connect(fd, (sockaddr*)&addr, sizeof(addr)) == 0) break;
      ::close(fd);
      fd = -1;
      if (waited >= timeout_ms) break;
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
    }
    if (fd < 0) {
      delete s;
      return -1;
    }
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    int32_t sid = my_id;
    if (!send_all(fd, reinterpret_cast<char*>(&sid), sizeof(sid))) {
      delete s;
      return -1;
    }
    s->fds[i] = fd;
  }
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next++;
  g_senders[h] = s;
  return h;
}

int nc_send(int64_t h, int recv_idx, const char* buf, int64_t size) {
  Sender* s;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_senders.find(h);
    if (it == g_senders.end()) return -1;
    s = it->second;
  }
  std::lock_guard<std::mutex> lk(s->mu);
  if (recv_idx < 0 || recv_idx >= (int)s->fds.size()) return -1;
  int fd = s->fds[recv_idx];
  if (!send_all(fd, reinterpret_cast<const char*>(&size), sizeof(size)))
    return -1;
  if (size > 0 && !send_all(fd, buf, size)) return -1;
  return 0;
}

void nc_sender_destroy(int64_t h) {
  Sender* s = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_senders.find(h);
    if (it == g_senders.end()) return;
    s = it->second;
    g_senders.erase(it);
  }
  delete s;
}

}  // extern "C"
